"""The SGPN cell (``sgpn.serve.room``) and the deferred burst cell
(``vlsat_mmgnet.serve.val_burst``, not in ``BENCHMARK.json``: its p50
spreads past its bound, ``PERF.md``) on the CPU at a small size (128 -> 32
points an instance and an edge's union cloud, rooms of at most 8 objects,
every width as published): each runs and reads correct; a fault under the
timed path (one wrong weight, union rows shipped out of order) and the
control read not correct; the union clouds are deterministic, f16-exact
and masked as their edges say; the bursts keep their mean and their
arrivals; the new metrics are read from a traced run; and the FLOP count
that the roofline and MFU readers divide agrees with ``FlopCounterMode``
on the reference."""

import json

import numpy as np
import pytest
import torch

from benchmark import control_sgpn, run
from benchmark.harness import core, roofline, scenes, union
from benchmark.harness.weights import build_reference
from benchmark.reference import plain
from benchmark.reference import sgpn as R
from benchmark.tests import tiny
from benchmark.traffic import serve_open_loop_burst as burst

CELL, BURST = "sgpn.serve.room", "vlsat_mmgnet.serve.val_burst"
SMALL = {"config": {"num_points": 32, "num_points_union": 32},
         "params": {"max_nodes": 8, "rate": 6, "max_batch": 4, "sample": 4, "ref_block": 4,
                    "grace_s": 30, "trace_s": 1}}


def _args(cell=CELL, seed=3000000023, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "2", "--trace", str(trace)]


def _line(capsys, trace=0, cell=CELL, overrides=SMALL, spec=None) -> dict:
    assert run.main(_args(cell, trace=trace), device=torch.device("cpu"),
                    overrides=json.loads(json.dumps(overrides)), spec=spec) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(trace, capsys):
    line = _line(capsys, trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in core.cell_metrics(spec, CELL, kind)}
    assert set(line["metrics"]) <= names
    if trace:  # the card's metrics need a card; the program's counters do not
        assert "union_h2d_mb.serve" in line["metrics"]
    else:
        assert set(line["metrics"]) == names == {"serve_p50_ms", "serve_scenes_per_s", "setup_s"}
    assert set(line["checks"]) == {"obj_logit_gap", "obj_logit_rms", "rel_prob_gap",
                                   "rel_prob_rms"}
    assert core.forbidden_modules() == []


def test_one_wrong_weight_is_not_correct(capsys, monkeypatch):
    from vlsat_tpu_torch.interop import torch_import

    real = torch_import.import_sgpn

    def altered(sds):
        out = real(sds)
        out["params"]["rel_encoder"]["conv3"]["bias"][0] += 0.5
        return out

    monkeypatch.setattr(torch_import, "import_sgpn", altered)
    line = _line(capsys)
    assert line["correct"] is False, line["checks"]


def test_union_rows_out_of_order_are_not_correct(capsys, monkeypatch):
    """The server ships each batch's union rows reversed: every answer's
    predicates are another edge's."""
    from vlsat_tpu_torch import serving

    real = serving._WireSet.put_union
    monkeypatch.setattr(serving._WireSet, "put_union",
                        lambda self, clouds, slots: real(self, clouds, slots).flip(0))
    line = _line(capsys)
    assert line["correct"] is False
    assert line["checks"]["rel_prob_gap"]["value"] > line["checks"]["rel_prob_gap"]["limit"]


def test_control_fails_the_check_on_the_cpu():
    line = control_sgpn.control(CELL, 7, torch.device("cpu"), SMALL)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.cuda
def test_control_fails_the_check_on_the_card(card):
    line = control_sgpn.control(CELL, 8, card)
    assert line["correct"] is False, line["checks"]


def _far_apart_scene():
    """Three instances of 64 points along x, at 0, 10 and 20: the box of
    (0, 2) holds instance 1 too, that of (0, 1) only its two ends."""
    rng = np.random.Generator(np.random.PCG64(3))
    pts = (rng.standard_normal((3, 64, 3)) * 0.5).astype(np.float32)
    centers = np.array([[0, 0, 0], [10, 0, 0], [20, 0, 0]], np.float32)
    desc = np.zeros((3, 11), np.float32)
    desc[:, :3] = centers
    return {"obj_points": pts - pts.mean(1, keepdims=True), "descriptor": desc,
            "edge_index": scenes.full_edge_index(3)}, centers


def test_union_clouds_are_deterministic_f16_exact_and_masked():
    scene, centers = _far_apart_scene()
    draw = lambda seed: union.make_unions([scene], seed, points=512)[0]
    a = draw(11)
    assert a.dtype == np.float16 and a.shape == (6, 512, 4)
    np.testing.assert_array_equal(a, draw(11))
    assert not np.array_equal(a, draw(12))
    pool = scenes.make_scenes(scenes.label_specs("val_splits")[:3], 5, num_points=32)
    for s, clouds in zip(pool, union.make_unions(pool, 5, points=32)):
        assert clouds.shape == (len(s["edge_index"]), 32, 4)
        assert np.array_equal(clouds.astype(np.float32).astype(np.float16), clouds)
    for k, (i, j) in enumerate(scene["edge_index"]):
        xyz, mask = a[k, :, :3].astype(np.float64), a[k, :, 3]
        assert set(np.unique(mask).tolist()) == ({0.0, 1.0, 2.0} if {i, j} == {0, 2}
                                                 else {1.0, 2.0})
        assert np.abs(xyz.mean(0)).max() < 1e-2  # zero-meaned before the f16 rounding
        # the subject's points sit where its instance sits, relative to the object's
        shift = xyz[mask == 1].mean(0) - xyz[mask == 2].mean(0)
        np.testing.assert_allclose(shift, centers[i] - centers[j], atol=0.2)
        if {i, j} == {0, 2}:
            np.testing.assert_allclose(xyz[mask == 0].mean(0) - xyz[mask == 2].mean(0),
                                       centers[1] - centers[j], atol=0.2)


def test_burst_arrivals_keep_their_mean_and_their_gaps():
    cell = core.load_cell(BURST)["params"]
    on, off = cell["burst_on_s"], cell["burst_off_s"]
    runs = [burst.arrivals(cell["rate"], 6.0, seed, on, off) for seed in (1, 2300000011)]
    cycles = [np.floor(d / (on + off) + 1e-9) for d in runs]
    for due, k in zip(runs, cycles):
        assert len(due) / 6.0 == pytest.approx(cell["rate"])
        assert (due - k * (on + off)).max() < on  # nothing arrives between bursts
    m = round(cell["rate"] * (on + off))  # a burst's requests
    quantile = np.sort(-np.log1p(-(np.arange(m) + 0.5) / m) * on / m)
    for c in range(10):  # each burst: serve_open_loop's gaps less the first, in the seed's order
        for d, k in zip(runs, cycles):
            gaps = np.sort(np.diff(d[k == c]))
            assert len(gaps) == m - 1
            drop = int(np.argmax(~np.isclose(gaps, quantile[:-1], rtol=0, atol=1e-12)))
            if np.allclose(gaps, quantile[:-1], rtol=0, atol=1e-12):
                drop = m - 1
            np.testing.assert_allclose(gaps, np.delete(quantile, drop), rtol=0, atol=1e-12)
    assert not np.array_equal(runs[0], runs[1])
    assert len(burst.arrivals(cell["rate"], 20.0, 5, on, off)) == 33 * round(
        cell["rate"] * (on + off))  # whole cycles only


def _burst_spec() -> dict:
    """``BENCHMARK.json`` with the deferred burst cell listed as serve.val is,
    judged on throughput and p50 as its generator reports them."""
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    assert BURST not in {w["name"] for w in spec["workloads"]}  # deferred (PERF.md)
    spec["workloads"].append({"name": BURST, "config": "vlsat_mmgnet",
                              "traffic": "serve.val_burst", "chips": 1})
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "vlsat_mmgnet.serve.val" in m.get("workloads", ()) or m["name"] == "serve_p50_ms":
                m["workloads"].append(BURST)
    return spec


def test_burst_cell_runs_on_the_cpu(capsys):
    small = tiny.overrides("vlsat_mmgnet.serve.val")
    spec = _burst_spec()
    line = _line(capsys, cell=BURST, overrides=small, spec=spec)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 3 * round(small["params"]["rate"] * 0.6)
    assert set(line["metrics"]) == {m["name"] for m in core.cell_metrics(spec, BURST,
                                                                          "end_to_end")} \
        == {"serve_p50_ms", "serve_scenes_per_s", "setup_s"}


def test_new_metrics_are_read_from_a_cpu_traced_run():
    """``union_h2d_mb.serve`` from the program's counters of the traced run;
    ``union_busy_ms.serve`` and ``pointnet_roofline.serve`` from its trace,
    given the device times that a card's trace would hold."""
    cell = core.load_cell(CELL)
    cfg = core.load_config(cell["config"])
    cfg.update(SMALL["config"])
    cell["params"].update(SMALL["params"])
    from benchmark.harness import spans
    from vlsat_tpu_torch.utils import profiling

    ctx = core.Context(cell=cell, config=cfg, seed=3000000029, seconds=2.0, trace=True,
                       device=torch.device("cpu"), t_process=0.0)
    profiling.clear()  # the spans of this process's earlier runs
    obs = core.load_generator(cell["generator"]).run(ctx)

    shipped = [s.attrs for s in spans.program_spans() if s.name == "serve.prepare"]
    mb = core.load_reader("union_h2d_mb.serve").read(obs, "union_h2d_mb.serve")
    assert mb == pytest.approx(sum(a["union_bytes"] for a in shipped) / len(shipped) / 1e6)
    assert all(a["union_bytes"] == a["union_rows"] * 32 * 4 * 2 for a in shipped)  # f16 wire
    tr = obs["trace"]
    assert tr["union"]["spans"] > 0 and tr["union"]["seconds"] == 0  # no device on the CPU
    for name in ("union_busy_ms.serve", "pointnet_roofline.serve"):
        assert core.load_reader(name).read(obs, name) is None
    batches = obs["traced_batches"]
    tr["union"]["seconds"] = 1e-3 * tr["union"]["spans"]
    tr["kernels"]["(anonymous namespace)::pointnet_kernel(float const*)"] = (2e-3, 7)
    obs["peaks"] = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert core.load_reader("union_busy_ms.serve").read(obs, "union_busy_ms.serve") == \
        pytest.approx(1.0)
    per_row, per_instance = obs["pointnet_flops"]
    assert per_row == 2 * 32 * (4 * 64 + 64 * 128 + 128 * 256)
    work = sum(e * per_row + n * per_instance for e, n in batches)
    assert core.load_reader("pointnet_roofline.serve").read(obs, "pointnet_roofline.serve") \
        == pytest.approx(100 * work * 3 / 495e12 / 2e-3)


def test_sgpn_flops_match_the_flop_counter_on_the_reference():
    cfg = core.load_config("sgpn")
    ref = build_reference(R.SGPNReference, torch.device("cpu"), 5, num_obj=160, num_rel=26)
    scene = scenes.make_scenes(scenes.label_specs("val_splits")[:1], 5)[0]
    scene["rel_points"] = union.make_unions([scene], 5, points=cfg["num_points_union"])[0]
    blk = plain.flatten([scene], torch.device("cpu"))
    clouds = torch.from_numpy(scene["rel_points"])
    with torch.no_grad():
        counted = roofline.count_flops(lambda: ref.forward_3d(blk, clouds))
    assert union.sgpn_flops(len(scene["gt_class"]), len(scene["edge_index"]), cfg) == counted
