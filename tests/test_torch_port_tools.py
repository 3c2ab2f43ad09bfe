"""The port's serving and operations tools (``vlsat_tpu_torch/tools/serve.py``,
``parity_eval.py`` and ``soak.py``) against their JAX twins under ``tools/``,
and the offline pipeline's frame decoder.

Where JAX has the same function the port's must give the same answer: the
serve tool's request pool (bit-equal points and 2D features, descriptors at
the parity gate of tests/test_parity_torch.py), the sweep's knee rule
(``tools/serve.py:150-170``, worked by hand below), the parity runbook's
metrics on one fabricated ``.pth`` directory and dataset (every metric
equal, NaN to NaN, as tests/test_torch_port_eval.py holds ``evaluate()``)
and its exit codes, and ``bench.predict_rate``.  Everything runs on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

from tests.mini_data import make_mini_dataset
from tests.test_parity_runbook import _fabricate_ckpt
from vlsat_tpu_torch.tools import parity_eval as port_parity
from vlsat_tpu_torch.tools import serve as port_serve
from vlsat_tpu_torch.tools import soak as port_soak

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-3, 1e-4


def _load(name: str, path: Path):
    """A repo-root script as a module, without putting its folder on sys.path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- serve

def test_serve_request_pool_equals_jax():
    from vlsat_tpu.data.synthetic import make_scene

    rng = np.random.RandomState(0)  # the JAX tool's pool (tools/serve.py:126-133)
    want = [make_scene(rng, n, num_points=128) for n in (9, 11, 12, 13, 14, 15, 16, 10)]
    got = port_serve.request_pool()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert sorted(g) == ["descriptor", "obj_2d_feats", "obj_points"]
        assert g["obj_points"].shape[0] == w["obj_points"].shape[0]
        np.testing.assert_array_equal(g["obj_points"], w["obj_points"])
        np.testing.assert_array_equal(g["obj_2d_feats"], w["obj_2d_feats"])
        np.testing.assert_allclose(g["descriptor"], w["descriptor"], rtol=RTOL, atol=ATOL)


def _row(clients, rate, p99):
    return {"clients": clients, "scenes_per_sec": rate, "p50_latency_ms": p99 / 2,
            "p99_latency_ms": p99, "mean_batch": 1.0}


# Curves with their knee and 100-ms operating point under JAX's rule, by hand:
# per1 = first rate / first clients; walk on while the marginal gain per
# added client is >= 0.25 * per1; the operating point is the fastest row
# with p99 <= the budget.
SWEEPS = {
    # per1 = 100; gains 50 (>= 25), then (170 - 150) / 2 = 10 (< 25): the knee
    # is the 2-client row; the fastest row within 100 ms the 4-client one
    "saturates": ([_row(1, 100, 10), _row(2, 150, 20), _row(4, 170, 90), _row(8, 180, 200)],
                  1, 2),
    # per1 = 100; gains 100, 100, 100: every step scales, knee at the end;
    # the fastest row within 100 ms is the 4-client one
    "scales": ([_row(1, 100, 10), _row(2, 200, 30), _row(4, 400, 80), _row(8, 800, 160)],
               3, 2),
    # per1 = 40 (2 clients); gain (50 - 80) / 2 < 10: the knee is the first row;
    # no row within 100 ms
    "first_row": ([_row(2, 80, 150), _row(4, 50, 300)], 0, None),
    # per1 = 100; gain (125 - 100) / 1 = 25 = 0.25 * per1 keeps walking, then
    # (130 - 125) / 2 < 25 stops: the knee is the 2-client row
    "boundary": ([_row(1, 100, 50), _row(2, 125, 60), _row(4, 130, 70)], 1, 2),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_summary_follows_jax_rule(name):
    curve, knee, op = SWEEPS[name]
    res = port_serve.sweep_summary(curve, 100.0)
    assert res["curve"] == curve and res["deadline_p99_ms"] == 100.0
    assert res["knee"] is curve[knee]
    assert res["deadline_operating_point"] is (None if op is None else curve[op])


def _bench_keys() -> set:
    """The keys of JAX's ``bench_server`` result, read off a stub server."""
    from vlsat_tpu.serving import bench_server

    class Stub:
        stats = {"batch_size_sum": 1, "batches": 1}

        def predict(self, scene):
            return {}

    return set(bench_server(Stub(), [{}], duration_s=0.01, clients=1))


@pytest.mark.parametrize("mode", ["load", "sweep"])
def test_serve_main_writes_jax_keys(tmp_path, mode):
    out = tmp_path / "serve.json"
    argv = ["--device", "cpu", "--max-batch", "4", "--duration", "0.5", "--clients", "2",
            "--out", str(out)]
    if mode == "load":
        res = port_serve.main(argv + ["--http", "--naive"])
        # tools/serve.py:184, :235-241, :267-268
        assert set(res) == {"batched", "http", "naive_per_scene_dispatch"}
        assert set(res["batched"]) == _bench_keys()
        assert set(res["http"]) == {"scenes_per_sec", "p50_latency_ms", "p99_latency_ms",
                                    "mean_batch_size"}
        assert set(res["naive_per_scene_dispatch"]) == {"scenes_per_sec"}
        assert all(v["scenes_per_sec"] > 0 for v in res.values())
    else:
        res = port_serve.main(argv + ["--sweep", "--sweep-clients", "2", "1",
                                      "--deadline-p99-ms", "1e9"])
        # tools/serve.py:159-163, :178-180
        assert set(res) == {"batched"}
        sweep = res["batched"]
        assert set(sweep) == {"curve", "knee", "deadline_p99_ms", "deadline_operating_point"}
        assert [r["clients"] for r in sweep["curve"]] == [1, 2]
        assert set(sweep["curve"][0]) == {"clients", "scenes_per_sec", "p50_latency_ms",
                                          "p99_latency_ms", "mean_batch"}
        assert sweep["deadline_operating_point"] in sweep["curve"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))


def test_serve_ckpt_answers_equal_restored_model(tmp_path):
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.serving import BatchedServer
    from vlsat_tpu_torch.train.checkpoint import CheckpointManager
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state

    ckpt = str(tmp_path / "ckpt")
    trained = build_mmgnet(MMGNetConfig(), "cpu", seed=3)  # not the tool's seed-0 init
    CheckpointManager(ckpt).save(
        create_train_state(trained, make_optimizer(lr=1e-4, max_iteration=1)), eva_res=0.5)
    pool = port_serve.request_pool()[:3]
    restored = build_mmgnet(MMGNetConfig(), "cpu", seed=0)
    with BatchedServer(restored, device="cpu", max_batch=4) as ref:
        init = [ref.predict(s) for s in pool]  # the tool's model without --ckpt
    assert CheckpointManager(ckpt).restore_model(restored, best=True)
    with BatchedServer(restored, device="cpu", max_batch=4) as ref:
        want = [ref.predict(s) for s in pool]
    args = port_serve.parse_args(["--device", "cpu", "--max-batch", "4", "--ckpt", ckpt])
    with port_serve.build_server(args) as server:
        got = [server.predict(s) for s in pool]
    for g, w, i in zip(got, want, init):
        for key in ("obj_logits", "rel_cls", "edge_index"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert not np.allclose(g["obj_logits"], i["obj_logits"], rtol=RTOL, atol=ATOL)

    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        port_serve.load_served(port_serve.parse_args(
            ["--device", "cpu", "--ckpt", str(tmp_path / "empty")]))


def test_http_frontend_queues_a_closed_loop_of_clients():
    """64 clients that connect at once all complete their handshake while
    the frontend accepts none: its listen backlog holds them (with
    socketserver's default of 5, the 7th connection already times out,
    and under the serve tool's 64-client load clients were reset)."""
    import socket

    from vlsat_tpu_torch.serving import HTTPFrontend

    fe = HTTPFrontend(server=None, port=0)  # bound and listening, not accepting
    socks = []
    try:
        for _ in range(64):
            socks.append(socket.create_connection(("127.0.0.1", fe.port), timeout=2))
    finally:
        for s in socks:
            s.close()
        fe.httpd.server_close()
    assert len(socks) == 64


# ----------------------------------------------------------- parity_eval

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The mini dataset and fabricated ``.pth`` directory of
    tests/test_parity_runbook.py, both packages' metrics on them, and a
    reference result.txt written from JAX's."""
    tmp = tmp_path_factory.mktemp("parity")
    root, scans = make_mini_dataset(tmp)
    ckpt = _fabricate_ckpt(tmp)
    jax_tool = _load("jax_parity_eval", REPO / "tools" / "parity_eval.py")
    kw = dict(ckpt_dir=ckpt, root=root, scans_root=scans, cache_root=str(tmp / "cache"),
              eval_batch_size=2, num_points=16, verbose=False)
    want, _ = jax_tool.run_parity_eval(**kw)
    got, ok = port_parity.run_parity_eval(**kw, out_json=str(tmp / "port.json"), device="cpu")
    labels = {key: label for label, key in jax_tool.REF_LABEL_TO_KEY.items()}
    finite = {k: v for k, v in want.items() if k in labels and np.isfinite(v)}
    argv = ["--ckpt-dir", ckpt, "--root", root, "--scans", scans, "--cache-root",
            str(tmp / "cache"), "--eval-batch-size", "2", "--num-points", "16"]
    return dict(tmp=tmp, jax_tool=jax_tool, want=want, got=got, ok=ok, labels=labels,
                finite=finite, argv=argv)


def test_parity_eval_metrics_equal_jax(parity):
    want, got = parity["want"], parity["got"]
    assert parity["ok"]  # no reference: vacuously within tolerance
    assert sorted(got) == sorted(want) and len(got) >= 30
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)
    saved = json.loads((parity["tmp"] / "port.json").read_text())
    assert set(saved) == {"metrics", "reference", "tolerance", "ok"}
    assert port_parity.REF_LABEL_TO_KEY == parity["jax_tool"].REF_LABEL_TO_KEY


@pytest.mark.parametrize("moved,rc", [(0.0, 0), (0.6, 1)])
def test_parity_eval_exit_codes_equal_jax(parity, moved, rc, capsys):
    """A self-comparison passes in both tools; one metric moved by 0.6
    points fails both (tolerance 0.5)."""
    ref = parity["tmp"] / f"result_{moved}.txt"
    shifted = dict(parity["finite"], obj_acc_1=parity["finite"]["obj_acc_1"] + moved)
    ref.write_text("".join(f"Eval: {parity['labels'][k]} : {v!r}\n"
                           for k, v in shifted.items()))
    assert port_parity.parse_reference_result(str(ref)) == \
        parity["jax_tool"].parse_reference_result(str(ref)) == shifted
    argv = parity["argv"] + ["--reference", str(ref)]
    assert parity["jax_tool"].main(argv) == rc
    jax_report = capsys.readouterr().out
    assert port_parity.main(argv + ["--device", "cpu"]) == rc
    port_report = capsys.readouterr().out
    verdict = "YES" if rc == 0 else "NO"
    assert f"parity within ±0.5 pts: {verdict}" in jax_report
    assert f"parity within ±0.5 pts: {verdict}" in port_report
    table = lambda text: [line for line in text.splitlines() if re.match(r"\w+ +-?[\d.n]", line)]
    assert table(port_report) == table(jax_report)


# ------------------------------------------------------------------ soak

def test_predict_rate_equals_bench():
    bench = _load("jax_bench", REPO / "bench.py")
    model = {"t_nolink_s": 0.031, "n_rtt": 3, "h2d_bytes": 2.5e6, "d2h_bytes": 4.0e5,
             "unit_scenes": 8}
    for link in ((1.5, 900.0, None), (0.2, 350.0, 120.0), (40.0, 0.0, 0.0)):
        assert port_soak.predict_rate(model, *link) == bench.predict_rate(model, *link)


def _jax_soak_keys() -> set:
    """Every key the JAX soak writes without ``--bench`` (tools/soak.py:320-406)."""
    src = (REPO / "tools" / "soak.py").read_text()
    body = src[src.index("res = {\"num_scans\""):src.index("# ---- compare against")]
    first = body[:body.index("}")]  # the dict the tool starts from
    return set(re.findall(r"\"(\w+)\": args\.", first)) | set(
        re.findall(r"res\[\"(\w+)\"\] =", body))


def test_soak_tiny_cpu_run(tmp_path, monkeypatch):
    """8 scans, 3 epochs, a SIGKILL once epoch 2 has started, then the
    resume: phase B at rc 0 within one epoch of the kill, the JAX tool's keys."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the training children share the workers' cores
    out = tmp_path / "soak.json"
    res = port_soak.main(["--num-scans", "8", "--epochs", "3", "--kill-epoch", "2",
                          "--valid-interval", "2", "--batch-size", "4", "--device", "cpu",
                          "--base", str(tmp_path / "base"), "--out", str(out)])
    assert set(res) == _jax_soak_keys()
    assert json.loads(out.read_text()) == res
    assert res["phase_b_rc"] == 0 and res["resumed_within_one_epoch_of_kill"]
    assert res["killed_at_epoch"] == 2 and res["final_epoch"] == 3
    assert [e["epoch"] for e in res["epoch_stats"]][:res["phase_a_epochs"]] == [1]
    assert all(np.isfinite(v["mean_recall_50"]) for v in res["val_trajectory"])
    assert not (tmp_path / "base").exists()  # removed without --keep


# --------------------------------------------------------- frame decoder

@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_read_frame_equals_imageio(tmp_path, ext):
    """The pipeline's PIL frame reader decodes PNG and JPEG frames to the
    arrays imageio (the JAX pipeline's reader) gives, bit for bit."""
    import imageio.v3 as iio
    from PIL import Image

    from vlsat_tpu_torch.tools.run_full_pipeline import read_frame

    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (54, 96, 3), dtype=np.uint8)
    paths = [tmp_path / f"pil.{ext}", tmp_path / f"iio.{ext}"]
    Image.fromarray(img).save(paths[0])
    iio.imwrite(paths[1], img)
    for p in paths:
        got, want = read_frame(str(p)), iio.imread(p)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == img.shape
        np.testing.assert_array_equal(got, want)
        if ext == "png":
            np.testing.assert_array_equal(got, img)
