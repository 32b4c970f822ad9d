"""Precision-provenance audit over the port's hot paths (aten-graph level;
the counterpart of ``repro.analysis.jaxpr``).

Where does the query pipeline widen a narrow dtype, and from which operand
did the narrow value come?  This module traces each registered hot path
with ``torch.fx.experimental.proxy_tensor.make_fx`` in real mode, on tiny
example inputs with its kernel switch off, and walks the aten graph node
by node as the reference walks a jaxpr's equations:

* every *narrow* input (int8/uint8/int16/uint16/float16/bfloat16) seeds a
  provenance record ``(origin argument, op chain)``;
* provenance flows through ops whose outputs stay narrow (``index``,
  ``slice``, ``view`` …), extending the chain;
* an op whose output is *wider* than a narrow input — a larger itemsize,
  or int → float — is a **widening**: reported with the op (``_to_copy``,
  ``mm``, …), the dtypes, the chain back to the origin argument, and the
  innermost line of the port from the node's ``stack_trace``.

What it keeps of the reference: the ``Widening`` record and its symbol
(hot path, origin, op, dtype pair — never a line), ``NARROW_DTYPES``, the
``_widens`` rule, the ``HOT_PATHS`` registry (the reference's seven paths,
each with its example inputs: the same numpy seeds and shapes), the
committed, reasoned inventory and its loader and writer.  What it leaves
out: the sub-jaxpr recursion and the boundary rule for opaque calls —
``make_fx`` traces through Python calls and ``nn.Module``s into one flat
graph, so provenance crosses a nested call without a rule of its own, and
a CUDA kernel is never traced (its switch is off; its plain version is).

The inventory is ``PRECISION_audit_torch.json`` (schema
``repro_torch.analysis.precision/v1``): every entry has a written reason
and, where the reference has one, the symbol of the reference's entry it
corresponds to (the op named by its JAX primitive, ``REFERENCE_PRIMS``).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import operator
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis.findings import Finding, reasoned_entries

AUDIT_SCHEMA = "repro_torch.analysis.precision/v1"
AUDIT_FILE = "PRECISION_audit_torch.json"
CHECK = "precision-widening"

#: dtypes whose values are tracked as "narrow" sources.  bool is excluded
#: (masks widen by design and carry one bit); int32/int64 index math is
#: excluded by construction.
NARROW_DTYPES = ("int8", "uint8", "int16", "uint16", "float16", "bfloat16")

#: aten op → the JAX primitive the reference's audit names for the same
#: step, for the ``reference`` symbol of an entry
REFERENCE_PRIMS = {"_to_copy": "convert_element_type", "index": "gather",
                   "mm": "dot_general"}


@dataclasses.dataclass
class Widening:
    hot_path: str            # registry name, e.g. "index.clustered._fused_rerank_block"
    path: str                # repo-relative source file of the hot path
    origin: str              # argument the narrow value came from
    prim: str                # aten op that widened it
    from_dtype: str
    to_dtype: str
    provenance: Tuple[str, ...]   # op chain origin → widening site
    line: int = 0            # port line (informational, not keyed)
    file: str = ""
    reference: str = ""      # the reference's symbol for it, if any

    @property
    def symbol(self) -> str:
        return (f"{self.hot_path}:{self.origin}:{self.prim}:"
                f"{self.from_dtype}->{self.to_dtype}")

    def to_json(self) -> dict:
        out = {
            "hot_path": self.hot_path, "path": self.path,
            "symbol": self.symbol, "origin": self.origin,
            "prim": self.prim, "from_dtype": self.from_dtype,
            "to_dtype": self.to_dtype,
            "provenance": list(self.provenance),
            "line": self.line, "file": self.file,
        }
        if self.reference:
            out["reference"] = self.reference
        return out


# -- the aten-graph walk ------------------------------------------------------

class _Prov:
    __slots__ = ("origin", "dtype", "chain")

    def __init__(self, origin: str, dtype: str, chain: Tuple[str, ...]):
        self.origin, self.dtype, self.chain = origin, dtype, chain


def _dtype_name(v) -> Optional[str]:
    return str(v.dtype).removeprefix("torch.") \
        if isinstance(v, torch.Tensor) else None


def _out_dtypes(node) -> List[Optional[str]]:
    """The dtype name of each output of ``node`` (None: not a tensor)."""
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return [_dtype_name(v) for v in val]
    return [_dtype_name(val)]


def _is_narrow(dt: Optional[str]) -> bool:
    return dt in NARROW_DTYPES


def _widens(from_dt: str, to_dt: str) -> bool:
    """Larger itemsize, or int→float at any size, counts as widening."""
    f, t = getattr(torch, from_dt, None), getattr(torch, to_dt, None)
    if not isinstance(f, torch.dtype) or not isinstance(t, torch.dtype):
        return False
    if t == torch.bool:
        return False                      # comparisons are not upcasts
    if t.itemsize > f.itemsize:
        return True
    return (not f.is_floating_point and not f.is_complex
            and f != torch.bool and t.is_floating_point)


def _op_name(target) -> str:
    """``aten._to_copy.default`` → ``_to_copy``."""
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(target)


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in ')


def _node_line(node) -> Tuple[str, int]:
    """The innermost frame of the port in the node's stack trace, as
    (repo-relative file, line); ("", 0) when the trace holds none."""
    here = Path(__file__).resolve()
    for fname, line in reversed(_FRAME.findall(node.stack_trace or "")):
        fname = fname.replace("\\", "/")
        if "/repro_torch/" in fname and Path(fname).resolve() != here:
            return ("src/repro_torch/" + fname.split("/repro_torch/", 1)[1],
                    int(line))
    return "", 0


def _functions(obj):
    if inspect.isfunction(obj):
        yield obj
    elif inspect.isclass(obj):
        yield from (f for f in vars(obj).values() if inspect.isfunction(f))


def _keep_port_frames() -> None:
    """Let ``make_fx`` keep the port's frames in each node's stack trace.

    Builds of torch whose tracer keeps only frames named ``forward`` (and
    registered anchors) in ``node.stack_trace`` have
    ``torch.fx.proxy._register_stack_trace_anchor``: every function of the
    loaded ``repro_torch`` modules is registered there.  A build without
    that registry keeps what its tracer keeps; lines are informational
    only (never keyed), so a widening with no frame of the port in its
    trace reports line 0."""
    anchor = getattr(torch.fx.proxy, "_register_stack_trace_anchor", None)
    if anchor is None:
        return
    for name, mod in list(sys.modules.items()):
        if mod is not None and name.split(".")[0] == "repro_torch":
            for obj in list(vars(mod).values()):
                if getattr(obj, "__module__", None) == name:
                    for fn in _functions(obj):
                        anchor(fn)


def _walk_graph(gm, prov: Dict[tuple, _Prov], hot_path: str, path: str,
                out: List[Widening]) -> None:
    seen = set()
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            dt = _dtype_name(getattr(gm, node.target, None))
            if _is_narrow(dt):
                prov[(node, 0)] = _Prov("<const>", dt, ())
            continue
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:      # one output of a tuple
            src, i = node.args
            if (src, i) in prov:
                prov[(node, 0)] = prov[(src, i)]
            continue
        narrow_ins = [prov[(n, 0)] for n in node.all_input_nodes
                      if (n, 0) in prov]
        if not narrow_ins:
            continue
        op = _op_name(node.target)
        for i, dt in enumerate(_out_dtypes(node)):
            if dt is None:
                continue
            if _is_narrow(dt):
                # stays narrow: extend the chain from the first narrow in
                p = narrow_ins[0]
                prov[(node, i)] = _Prov(p.origin, dt, p.chain + (op,))
                continue
            for p in narrow_ins:
                if not _widens(p.dtype, dt):
                    continue
                w = Widening(
                    hot_path=hot_path, path=path, origin=p.origin,
                    prim=op, from_dtype=p.dtype, to_dtype=dt,
                    provenance=p.chain + (op,))
                w.file, w.line = _node_line(node)
                if w.symbol not in seen:
                    seen.add(w.symbol)
                    out.append(w)
                break


def trace_widenings(fn: Callable, args: Sequence, arg_names: Sequence[str],
                    *, hot_path: str, path: str) -> List[Widening]:
    """Trace ``fn(*args)`` (tensors, on any device) to an aten graph and
    report every widening of a narrow-dtyped argument, with provenance.
    ``arg_names`` label the positional args (the origin names)."""
    def forward(*xs):
        return fn(*xs)

    _keep_port_frames()
    gm = make_fx(forward, tracing_mode="real",
                 record_stack_traces=True)(*args)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    prov: Dict[tuple, _Prov] = {}
    for node, name in zip(placeholders, arg_names):
        dt = _out_dtypes(node)[0]
        if _is_narrow(dt):
            prov[(node, 0)] = _Prov(name, dt, ())
    out: List[Widening] = []
    _walk_graph(gm, prov, hot_path, path, out)
    return out


# -- hot-path registry --------------------------------------------------------

@dataclasses.dataclass
class HotPath:
    name: str
    path: str                       # repo-relative source file
    build: Callable                 # (device, use_kernel) -> (fn, call,
                                    #   make_args, arg_names)
    reference: str                  # the reference's hot-path name


def _np_ratings(u=8, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 6, size=(u, d)).astype(np.int8)


def _on(device, x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _common(device):
    r_gather = _on(device, _np_ratings())            # int8 gather source
    ratings = r_gather.float()
    norms = torch.sqrt((ratings * ratings).sum(-1))
    counts = (ratings > 0).sum(-1).float()
    return r_gather, ratings, norms, counts


def _proxies(device, seed):
    rng = np.random.default_rng(seed)
    return _on(device, rng.normal(size=(8, 4)), torch.float32)


def _build_fused_scan_pool(device, use_kernel):
    from repro_torch.index import clustered as cl
    fn = cl._fused_scan_pool

    def make_args():
        return (_proxies(device, 1), _on(device, [0, 3], torch.int32))

    call = functools.partial(fn, m=3, use_kernel=use_kernel)
    return fn, call, make_args, ("proxies", "q_ids")


def _build_fused_scan_restricted(device, use_kernel):
    from repro_torch.index import clustered as cl
    fn = cl._fused_scan_restricted

    def make_args():
        return (_proxies(device, 2), _on(device, [1, 2, 4, 6, 8], torch.int32),
                _on(device, [0, 3], torch.int32))

    call = functools.partial(fn, m=3, use_kernel=use_kernel)
    return fn, call, make_args, ("proxies", "cand_pad", "q_ids")


def _build_fused_rerank_block(device, use_kernel):
    """The port's signature has no ``ratings``: the query rows come from
    ``r_gather``."""
    from repro_torch.index import clustered as cl
    fn = cl._fused_rerank_block

    def make_args():
        r_gather, _, norms, counts = _common(device)
        q_ids = _on(device, [0, 3], torch.int32)
        shorts = _on(device, [[1, 2, 8], [4, 5, 8]], torch.int32)
        return (r_gather, norms, counts, q_ids, shorts)

    call = functools.partial(fn, k=2, measure="pcc_sig", beta=50.0,
                             use_kernel=use_kernel)
    return fn, call, make_args, ("r_gather", "norms", "counts", "q_ids",
                                 "shorts")


def _build_rerank_sparse(device, use_kernel):
    """No kernel of its own: ``use_kernel`` changes nothing."""
    from repro_torch.index import clustered as cl
    fn = cl._rerank_sparse

    def make_args():
        r_gather, _, norms, counts = _common(device)
        q_ids = _on(device, [0, 3], torch.int32)
        q_items = _on(device, [[0, 2, 4], [1, 3, 5]], torch.int32)
        q_vals = _on(device, [[5.0, 3.0, 0.0], [4.0, 1.0, 2.0]],
                     torch.float32)
        cand_ids = _on(device, [[1, 2, 8], [4, 5, 8]], torch.int32)
        return (r_gather, norms, counts, q_ids, q_items, q_vals, cand_ids)

    call = functools.partial(fn, k=2, measure="pcc_sig", beta=50.0)
    return fn, call, make_args, ("r_gather", "norms", "counts", "q_ids",
                                 "q_items", "q_vals", "cand_ids")


def _build_rerank_scores(device, use_kernel):
    from repro_torch.kernels import rerank as rk
    fn = rk.fused_rerank_scores if use_kernel else rk.rerank_scores_plain

    def make_args():
        r_gather, ratings, norms, counts = _common(device)
        # int8 candidate rows and f32 query rows, as in the reference's inputs
        return (ratings[:2], r_gather[:4], norms[:4], counts[:4])

    call = functools.partial(fn, measure="pcc_sig", beta=50.0)
    return fn, call, make_args, ("q_vals", "cand_rows", "cand_norms",
                                 "cand_counts")


def _build_scan_topm(device, use_kernel):
    from repro_torch.kernels import select as sel
    fn = sel.fused_scan_topm if use_kernel else sel.scan_topm_twin

    def make_args():
        proxies = _proxies(device, 3)
        return (proxies[:2], proxies, _on(device, [0, 3], torch.int32))

    call = functools.partial(fn, m=3)
    return fn, call, make_args, ("q", "proxies", "q_ids")


def _build_support_scores(device, use_kernel):
    from repro_torch.kernels import support as sup
    fn = sup.fused_support_scores if use_kernel \
        else sup.support_scores_plain

    def make_args():
        rng = np.random.default_rng(4)
        dev = _on(device, rng.normal(size=(8, 6)), torch.float32)
        msk = _on(device, rng.random((8, 6)) > 0.5, torch.float32)
        nb_idx = _on(device, [[0, 1], [2, 3]], torch.int32)
        nb_w = _on(device, [[0.5, 0.5], [1.0, 0.0]], torch.float32)
        q_means = _on(device, [3.0, 2.5], torch.float32)
        return (dev, msk, nb_idx, nb_w, q_means)

    return fn, fn, make_args, ("dev", "msk", "nb_idx", "nb_w", "q_means")


_CLUSTERED = "src/repro_torch/index/clustered.py"

#: The port's twins of the reference's seven hot paths (the fused query
#: pipeline and its twins), in execution order.  ``build(device,
#: use_kernel)``: the audit traces with the kernels off (their plain
#: versions); the retrace check calls them on (the CUDA kernels on the
#: card, the plain versions on the CPU).
HOT_PATHS: Tuple[HotPath, ...] = (
    HotPath("index.clustered._fused_scan_pool", _CLUSTERED,
            _build_fused_scan_pool, "index.clustered._fused_scan_pool"),
    HotPath("index.clustered._fused_scan_restricted", _CLUSTERED,
            _build_fused_scan_restricted,
            "index.clustered._fused_scan_restricted"),
    HotPath("index.clustered._fused_rerank_block", _CLUSTERED,
            _build_fused_rerank_block, "index.clustered._fused_rerank_block"),
    HotPath("index.clustered._rerank_sparse", _CLUSTERED,
            _build_rerank_sparse, "index.clustered._rerank_sparse"),
    HotPath("kernels.rerank.rerank_scores_plain",
            "src/repro_torch/kernels/rerank.py", _build_rerank_scores,
            "kernels.rerank.rerank_scores_xla"),
    HotPath("kernels.select.scan_topm_twin",
            "src/repro_torch/kernels/select.py", _build_scan_topm,
            "kernels.select.scan_topm_xla"),
    HotPath("kernels.support.support_scores_plain",
            "src/repro_torch/kernels/support.py", _build_support_scores,
            "kernels.support.fused_support_scores"),
)


def run_precision_audit(hot_paths: Sequence[HotPath] = HOT_PATHS,
                        device="cpu") -> List[Widening]:
    """Trace every registered hot path on ``device`` (kernels off); returns
    all widenings found, each with its reference symbol where the op has a
    counterpart primitive."""
    out: List[Widening] = []
    for hp in hot_paths:
        _, call, make_args, arg_names = hp.build(torch.device(device), False)
        for w in trace_widenings(call, make_args(), arg_names,
                                 hot_path=hp.name, path=hp.path):
            if w.prim in REFERENCE_PRIMS:
                w.reference = (f"{hp.reference}:{w.origin}:"
                               f"{REFERENCE_PRIMS[w.prim]}:"
                               f"{w.from_dtype}->{w.to_dtype}")
            out.append(w)
    return out


def widening_findings(widenings: Sequence[Widening]) -> List[Finding]:
    return [Finding(
        check=CHECK, path=w.path, line=w.line, col=0, symbol=w.symbol,
        message=f"{w.hot_path}: {w.origin} ({w.from_dtype}) widened to "
                f"{w.to_dtype} by {w.prim} (provenance "
                f"{' -> '.join(w.provenance)}) — either intentional "
                f"(baseline it in {AUDIT_FILE} with a reason) or a "
                f"bandwidth regression") for w in widenings]


# -- the committed audit file -------------------------------------------------

def load_audit(path) -> Dict[Tuple[str, str, str], str]:
    """``PRECISION_audit_torch.json`` → baseline map {(check, path, symbol):
    reason}; a missing file is empty, a reasonless entry or another schema
    is a ``ValueError``."""
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    if data.get("schema") != AUDIT_SCHEMA:
        raise ValueError(f"unsupported precision-audit schema in {path}: "
                         f"{data.get('schema')!r}")
    return {(CHECK, e["path"], e["symbol"]): e["reason"].strip()
            for e in reasoned_entries(data.get("entries", []), path)}


def write_audit(path, widenings: Sequence[Widening],
                reasons: Optional[Dict[str, str]] = None) -> int:
    """Write the audit file from a fresh trace, preserving ``reasons``
    (symbol → reason, e.g. from the previous audit) and stamping ``TODO``
    on new entries for the operator to fill in."""
    reasons = reasons or {}
    entries = []
    for w in sorted(widenings, key=lambda w: (w.path, w.symbol)):
        e = w.to_json()
        e["reason"] = reasons.get(w.symbol, "TODO: justify or eliminate")
        entries.append(e)
    Path(path).write_text(json.dumps(
        {"schema": AUDIT_SCHEMA, "entries": entries}, indent=2,
        ensure_ascii=False) + "\n")
    return len(entries)
