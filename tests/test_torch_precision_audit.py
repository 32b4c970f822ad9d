"""The port's trace-level checks (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the aten-graph precision audit traces
seeded int8 → f32 widenings with provenance (through nested calls), stays
quiet on clean code, and the committed ``PRECISION_audit_torch.json`` is
exactly a fresh CPU trace of the port's hot paths — the same three
widenings as the reference's committed ``PRECISION_audit.json``, op for
primitive.  The retrace sentinel counts the kernels' build and load
events in its window and none over warm re-calls."""

import json
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import (RetraceSentinel, main, run_trace_checks,
                                  steady_state_findings)
from repro_torch.analysis import precision as P
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
AUDIT = REPO / "PRECISION_audit_torch.json"
REF_AUDIT = REPO / "PRECISION_audit.json"

# the port's aten op → the reference's jaxpr primitive for the same step
ATEN_TO_PRIM = {"_to_copy": "convert_element_type", "index": "gather",
                "mm": "dot_general"}


def _i8(shape=(4, 3), seed=0):
    return torch.from_numpy(np.random.default_rng(seed)
                            .integers(1, 6, shape).astype(np.int8))


def _trace(fn, x, name="x", hot_path="fixture.f"):
    return P.trace_widenings(fn, [x], [name], hot_path=hot_path,
                             path="fixture.py")


# -- seeded widenings ---------------------------------------------------------

def test_seeded_int8_upcast_fires_exactly_once():
    ws = _trace(lambda x: x.to(torch.float32).sum(), _i8(), "ratings",
                "fixture.upcast")
    assert len(ws) == 1
    w = ws[0]
    assert w.origin == "ratings"
    assert (w.from_dtype, w.to_dtype, w.prim) == ("int8", "float32",
                                                  "_to_copy")
    assert w.symbol == "fixture.upcast:ratings:_to_copy:int8->float32"


def _inner(x):
    return x.float()


def test_widening_traced_through_nested_call():
    """make_fx traces through Python calls: provenance crosses the nested
    function with its chain intact (the reference's jit-boundary test)."""
    def f(x):
        g = x[torch.tensor([0, 1])]          # index keeps it narrow
        return _inner(g).sum()

    ws = _trace(f, _i8(), "ratings", "fixture.nested")
    assert len(ws) == 1
    assert ws[0].origin == "ratings"
    assert ws[0].provenance == ("index", "_to_copy")


def test_widening_traced_through_module():
    class Cast(torch.nn.Module):
        def forward(self, x):
            return _inner(x[1:]) * 2

    ws = _trace(Cast(), _i8(), "ratings", "fixture.module")
    assert [w.symbol for w in ws] == [
        "fixture.module:ratings:_to_copy:int8->float32"]


@pytest.mark.parametrize("fn", [
    lambda x: x * x,                                 # int8 arithmetic
    lambda x: x.sum(dtype=torch.int8),               # explicit dtype
], ids=["mul", "sum_int8"])
def test_clean_twin_is_quiet(fn):
    assert _trace(fn, _i8()) == []


def test_float32_inputs_never_flag():
    x = torch.ones((4, 3), dtype=torch.float32)
    assert _trace(lambda x: x.double().sum() + x.sum(), x) == []


def test_bool_comparisons_are_not_widenings():
    """int8 > 0 gives bool: a mask, not a precision event; the sum of the
    bools widens from bool, which is not tracked either."""
    assert _trace(lambda x: (x > 0).sum(), _i8()) == []


def test_narrowing_is_not_a_widening():
    x = torch.ones((4,), dtype=torch.float32)
    assert _trace(lambda x: x.to(torch.int8), x) == []


@pytest.mark.parametrize("src,dst,want", [
    ("int8", "float32", True), ("int8", "int16", True),
    ("int16", "float16", True), ("bfloat16", "float32", True),
    ("float16", "bfloat16", False), ("int8", "bool", False),
    ("float32", "int8", False), ("int8", "int8", False)])
def test_widens_rule(src, dst, want):
    assert P._widens(src, dst) is want


# -- findings + audit file machinery ------------------------------------------

def test_widening_findings_carry_symbol_and_check():
    ws = _trace(lambda x: x.float(), _i8())
    fs = P.widening_findings(ws)
    assert len(fs) == 1
    assert fs[0].check == "precision-widening"
    assert fs[0].symbol == ws[0].symbol
    assert "PRECISION_audit_torch.json" in fs[0].message


def test_load_audit_rejects_reasonless_entry(tmp_path):
    p = tmp_path / "audit.json"
    p.write_text(json.dumps({"schema": P.AUDIT_SCHEMA, "entries": [
        {"path": "x.py", "symbol": "s", "reason": "  "}]}))
    with pytest.raises(ValueError, match="reason"):
        P.load_audit(p)
    assert main(["--device", "cpu", "--precision-audit", str(p)]) == 2


def test_load_audit_rejects_wrong_schema(tmp_path):
    p = tmp_path / "audit.json"
    p.write_text(json.dumps({"schema": "repro.analysis.precision/v1",
                             "entries": []}))
    with pytest.raises(ValueError, match="schema"):
        P.load_audit(p)


def test_write_audit_preserves_reasons_and_stamps_todo(tmp_path):
    ws = _trace(lambda x: x.float(), _i8())
    p = tmp_path / "audit.json"
    assert P.write_audit(p, ws, reasons={ws[0].symbol: "known exact"}) == 1
    assert json.loads(p.read_text())["entries"][0]["reason"] == "known exact"
    P.write_audit(p, ws)                     # no reasons: TODO stamp
    assert json.loads(p.read_text())["entries"][0]["reason"].startswith(
        "TODO")


# -- the committed audit against a live trace and the reference's ------------

def test_committed_audit_matches_live_trace():
    """Every entry fires in a fresh CPU trace and every live widening is
    in the file, field for field (the line aside: informational)."""
    data = json.loads(AUDIT.read_text())
    assert data["schema"] == P.AUDIT_SCHEMA
    P.load_audit(AUDIT)                      # raises on a missing reason

    def key(e):
        return {k: v for k, v in e.items() if k not in ("line", "reason")}

    live = sorted((key(w.to_json()) for w in P.run_precision_audit()),
                  key=lambda e: e["symbol"])
    committed = sorted((key(e) for e in data["entries"]),
                       key=lambda e: e["symbol"])
    assert committed == live, (
        "audit drift — regenerate with python -m repro_torch.analysis "
        "--device cpu --write-precision-audit and justify the delta")
    assert all(e["file"] and e["line"] > 0 for e in data["entries"])


def test_audit_maps_to_the_reference_audit():
    """The port's (hot path, origin, op, dtypes, chain) inventory, each op
    named by its reference primitive, is the reference's committed one."""
    ref_of = {hp.name: hp.reference for hp in P.HOT_PATHS}
    port = {(ref_of[e["hot_path"]], e["origin"],
             ATEN_TO_PRIM[e["prim"]], e["from_dtype"], e["to_dtype"],
             tuple(ATEN_TO_PRIM[op] for op in e["provenance"]))
            for e in json.loads(AUDIT.read_text())["entries"]}
    ref = {(e["hot_path"], e["origin"], e["prim"], e["from_dtype"],
            e["to_dtype"], tuple(e["provenance"]))
           for e in json.loads(REF_AUDIT.read_text())["entries"]}
    assert len(ref) == 3
    assert port == ref
    for e in json.loads(AUDIT.read_text())["entries"]:
        assert e["reference"] in {r["symbol"] for r in json.loads(
            REF_AUDIT.read_text())["entries"]}


def test_hot_paths_are_the_reference_twins():
    """The seven hot paths name the reference's seven, and their example
    inputs are the reference's (same seeds, shapes, values, dtypes)."""
    from repro.analysis import jaxpr as J
    ref = {hp.name: hp for hp in J.HOT_PATHS}
    assert [hp.reference for hp in P.HOT_PATHS] == list(ref)
    for hp in P.HOT_PATHS:
        _, _, make_args, names = hp.build(torch.device("cpu"), False)
        _, _, ref_make_args, ref_names = ref[hp.reference].build()
        ref_args = dict(zip(ref_names, ref_make_args()))
        assert set(names) <= set(ref_args), hp.name
        for name, x in zip(names, make_args()):
            want = np.asarray(ref_args[name])
            assert str(x.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_array_equal(x.numpy(), want,
                                          err_msg=f"{hp.name}.{name}")


# -- the retrace sentinel -----------------------------------------------------

def test_steady_state_is_quiet_on_cpu():
    assert steady_state_findings(device="cpu") == []
    assert obs.registry().gauge("analysis.retrace.count").value == 0.0


def test_trace_checks_pass_on_the_committed_audit():
    fs, stale = run_trace_checks(device="cpu", audit_path=AUDIT)
    assert stale == [] and [f for f in fs if f.active] == []
    assert main(["--device", "cpu", "--precision-audit", str(AUDIT)]) == 0


def test_stale_or_missing_entry_fails_the_gate(tmp_path):
    data = json.loads(AUDIT.read_text())
    stale = dict(data["entries"][0], symbol="index.clustered.gone:x:"
                 "_to_copy:int8->float32")
    p = tmp_path / "audit.json"
    p.write_text(json.dumps(dict(data, entries=data["entries"] + [stale])))
    assert main(["--device", "cpu", "--precision-audit", str(p)]) == 2
    p.write_text(json.dumps(dict(data, entries=data["entries"][1:])))
    assert main(["--device", "cpu", "--precision-audit", str(p)]) == 1


def test_sentinel_counts_events_in_its_window():
    _build._compile_event("load", "before")            # outside: not counted
    with RetraceSentinel("fixture") as s:
        _build._compile_event("load", "standin")
    _build._compile_event("load", "after")
    assert s.count == 1 and s.events == [("load", "standin")]
    assert obs.registry().gauge("analysis.retrace.count").value == 1.0


@pytest.fixture
def standin_library(tmp_path, monkeypatch):
    """A stand-in kernel source and compiler: the "nvcc" copies a shared
    library that ``ctypes`` can open (this interpreter's ``_ctypes``)."""
    import _ctypes
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "standin.cu").write_text("// stand-in\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport shutil, sys\n"
                    f"shutil.copy({_ctypes.__file__!r}, "
                    f"sys.argv[sys.argv.index('-o') + 1])\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    return "standin"


def test_build_listener_sees_one_build_and_one_load(standin_library,
                                                    monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "COMPILE_LISTENERS", [
        lambda event, name: seen.append((event, name))])
    first = _build.load(standin_library)
    assert _build.load(standin_library) is first        # cached: no event
    assert seen == [("build", standin_library), ("load", standin_library)]


def test_sentinel_counts_a_real_build_and_load(standin_library):
    with RetraceSentinel("fixture.build", publish=False) as s:
        _build.load(standin_library)
    with RetraceSentinel("fixture.warm", publish=False) as warm:
        _build.load(standin_library)
    assert s.events == [("build", standin_library),
                        ("load", standin_library)]
    assert warm.count == 0
