"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as files, with a workload entry naming them, are
found by name with no edit to any file that was there."""

import json

from cfbench.tests import tiny


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    from cfbench import harness
    monkeypatch.setattr(harness, "UNTRACED_SECONDS", 0.05)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    here = tiny.tiny_tree(tmp_path)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "ml1m.json").read_text())
    cfg.update(name="throwaway", n_users=120, n_items=90, n_ratings=2400)
    (here / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "refit.json").read_text())
    traffic.update(new_ratings=7, warmup_steps=2)
    (here / "traffic" / "slow_refit.json").write_text(json.dumps(traffic))
    (here / "metrics" / "throwaway_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "test",
                             "file": "cfbench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.slow_refit",
                               "config": "throwaway",
                               "traffic": "slow_refit", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("throwaway.slow_refit")
    bench["per_layer"].append({"name": "throwaway_steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "fit_s",
                               "workloads": ["throwaway.slow_refit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    out = tiny.run(here, "throwaway.slow_refit", trace=False)
    assert out["correct"] and set(out["metrics"]) == {"fit_s", "setup_s"}
    out = tiny.run(here, "throwaway.slow_refit", trace=True)
    assert out["correct"] and out["metrics"]["throwaway_steps"]["value"] >= 1
