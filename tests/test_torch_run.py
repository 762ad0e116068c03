"""The port's by-name runner and what it needs, against the JAX package
on the CPU: the configs and gates (`core/config.py`), `evaluate_checks`
on crafted results and on the committed artifacts, `pose_like`'s
deterministic part, the missing-data holdout, the ARD metrics,
`JsonlLogger`, and `experiments/run.py` end to end at tiny f64 widths
(c3 on the reference runner's own data and first init; c9 staged, and in
one phase streamed, with the draw of `two_view_big` held against the
reference's)."""
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.core import config as jconfig
from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import mrd as jmrd
from dp_gp_lvm_tpu.train import logging as jlogging
from dp_gp_lvm_tpu_torch.core import config, prng
from dp_gp_lvm_tpu_torch.data import mocap, synthetic
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz
from dp_gp_lvm_tpu_torch.train.logging import JsonlLogger

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = {"c1_bgplvm_toy": "c1", "c2_sparse_oil": "c2",
             "c3_mrd_twoview": "c3", "c4_dp_mocap": "c4",
             "c5_dp_missing": "c5", "c5_pose_missing": "c5_pose",
             "c6_svi_bigN": "c6", "c7_dp_svi": "c7",
             "c8_amortized_svi": "c8", "c9_mrd_svi_bigN": "c9"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _artifact(name):
    with open(ROOT / "results" / ARTIFACTS[name] / "result.json") as fh:
        return json.load(fh)


def test_configs_and_gates_are_the_references():
    assert set(config.CONFIGS) == set(ARTIFACTS)
    for name, cfg in config.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jconfig.get(name))
        assert config.get(name) is cfg
        assert config.CHECKS[name] == jconfig.CHECKS[name]
    assert set(config.CHECKS) == set(ARTIFACTS)
    with pytest.raises(KeyError, match="unknown config"):
        config.get("c10_not_a_config")


CRAFTED = {
    "pass": ("c5_dp_missing", {"imputation_mse": 0.002,
                               "predictive_loglik_per_dim": 0.6,
                               "calibration_ratio": 0.04}),
    "missing_key": ("c5_dp_missing", {"imputation_mse": 0.002,
                                      "calibration_ratio": 0.04}),
    "none_value": ("c2_sparse_oil", {"elbo": None}),
    "two_sided_high": ("c5_pose_missing", {"imputation_mse": 0.1,
                                           "predictive_loglik_per_dim": 0.0,
                                           "calibration_ratio": 6.0}),
    "two_sided_low": ("c5_pose_missing", {"imputation_mse": 0.2,
                                          "predictive_loglik_per_dim": -0.3,
                                          "calibration_ratio": 0.1}),
    "nested_nan": ("c1_bgplvm_toy", {"elbo": -800.0, "ard_recall_top2": 1.0,
                                     "ard_separation_ratio": 40.0,
                                     "ard_weights": [0.8, math.nan, 0.01]}),
    "deep_inf_and_bool": ("c4_dp_mocap", {
        "elbo": math.inf, "ok": True,
        "nested": {"a": [1, {"b": -math.inf}], "c": "text"}}),
    "ungated_name": ("c9_not_ported", {"elbo": math.nan, "steps": 3}),
}


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_evaluate_checks_matches_reference_on_crafted_results(case):
    name, result = CRAFTED[case]
    got = config.evaluate_checks(name, result)
    assert got == jconfig.evaluate_checks(name, result)
    assert bool(got) == (case != "pass")


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_evaluate_checks_matches_reference_on_committed_artifacts(name):
    result = _artifact(name)
    assert config.evaluate_checks(name, result) == \
        jconfig.evaluate_checks(name, result) == []
    bad = dict(result, elbo=math.nan)
    assert config.evaluate_checks(name, bad) == \
        jconfig.evaluate_checks(name, bad)


def test_pose_like_from_the_references_draws():
    """The deterministic part (gait, mirrored limb mix, forward
    kinematics, the 1e-3 floored standardization) fed jax.random's draws
    as pose_like splits them."""
    n, q = 48, 3
    key = jax.random.PRNGKey(3)
    want = jsyn.pose_like(key, n=n, q_true=q, dtype=jnp.float64)
    r1, r2, r3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(r1, (1, q), jnp.float64, 0.0, 2 * jnp.pi),
             0.5 * jax.random.normal(r2, (5, q), jnp.float64),
             jax.random.normal(r3, (n, 32), jnp.float64))
    got = synthetic.pose_from_draws(*(torch.tensor(np.asarray(x))
                                      for x in draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    # the port's own draw: the same shapes, standardized, and repeatable
    Y, X, groups = synthetic.pose_like(prng.PRNGKey(3), n=n, device="cpu")
    again, _, _ = synthetic.pose_like(prng.PRNGKey(3), n=n, device="cpu")
    assert Y.shape == (n, 32) and X.shape == (n, q) and groups.shape == (16,)
    assert torch.equal(Y, again)
    np.testing.assert_allclose(Y.mean(0).numpy(), 0.0, atol=1e-12)


def _reference_holdout(Y):
    """experiments/run.py:250-264, the c5 branch of the reference."""
    Y_all = np.asarray(Y)
    keep = np.ones(Y_all.shape[0], bool)
    keep[7::8] = False
    Y_train_np, Y_test_np = Y_all[keep], Y_all[~keep]
    mu_tr = Y_train_np.mean(axis=0)
    sd_tr = Y_train_np.std(axis=0) + 1e-8
    return (Y_train_np - mu_tr) / sd_tr, (Y_test_np - mu_tr) / sd_tr


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_holdout_split_matches_reference(dtype):
    Y = np.random.default_rng(2).normal(1.0, 3.0, (61, 7)).astype(dtype)
    got, want = runner.holdout_split(Y), _reference_holdout(Y)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (54, 7) and got[1].shape == (7, 7)


def _reference_ard_metrics(ard):
    """experiments/run.py:789-806, the c1 branch of the reference."""
    ard = jnp.asarray(ard)
    order = jnp.argsort(-ard)
    top2 = set(int(i) for i in order[:2])
    active = ard[jnp.array([0, 1])]
    inactive = ard[jnp.arange(2, ard.shape[0])]
    return {
        "ard_weights": [round(float(a), 6) for a in ard],
        "ard_recall_top2": len(top2 & {0, 1}) / 2.0,
        "ard_separation_ratio": float(
            jnp.min(active) / jnp.maximum(jnp.max(inactive), 1e-12)),
    }


@pytest.mark.parametrize("ard", [
    [0.805595, 1.006849, 0.003305, 0.01674, 0.003406, 0.003259],
    [0.9, 0.02, 0.5, 0.0, 0.0, 0.1],
    [0.3, 0.3, 0.3, 0.3, 1e-14, 0.2],
], ids=["committed", "one_missed", "ties"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ard_metrics_match_reference(ard, dtype):
    ard = np.asarray(ard, dtype)
    assert runner.ard_metrics(torch.as_tensor(ard)) == \
        _reference_ard_metrics(ard)


def test_jsonl_logger_matches_reference():
    ours, theirs = io.StringIO(), io.StringIO()
    for logger, fh in ((JsonlLogger(stream=ours), ours),
                       (jlogging.JsonlLogger(stream=theirs), theirs)):
        logger.log(49, elbo=torch.tensor(-12.5) if fh is ours else -12.5,
                   tag="text", n=3)
        logger.log(99, elbo=1.25)
    a, b = ([json.loads(line) for line in fh.getvalue().splitlines()]
            for fh in (ours, theirs))
    for rec in a + b:
        assert rec.pop("wall_dt_s") >= 0.0
    assert a == b == [{"step": 49, "elbo": -12.5, "tag": "text", "n": 3.0},
                      {"step": 99, "elbo": 1.25}]


def test_load_data_draws_each_dataset():
    for name, shape, tag in (
            ("c1_bgplvm_toy", (30, 10), "toy_gplvm"),
            ("c2_sparse_oil", (1000, 12), "synthetic:oil_flow_like"),
            ("c4_dp_mocap", (30, 59), "synthetic:mocap_like"),
            ("c5_pose_missing", (30, 32), "synthetic:pose_like"),
            # c7 draws its 512 held-out rows with its training rows
            ("c7_dp_svi", (30 + 512, 32), "synthetic:grouped_big")):
        cfg = dataclasses.replace(config.get(name), n=30, seed=4)
        Y, got_tag = runner.load_data(cfg, torch.float64, "cpu")
        assert (tuple(Y.shape), got_tag) == (shape, tag)
        assert bool(torch.isfinite(Y).all())
    # the oil-flow surrogate ignores the config's seed and size
    c2 = config.get("c2_sparse_oil")
    a, _ = runner.load_data(c2, torch.float64, "cpu")
    b, _ = runner.load_data(dataclasses.replace(c2, seed=9), torch.float64,
                            "cpu")
    assert torch.equal(a, b)


TINY = {
    # c5's own M = 64 does not fit a 56-row train split
    "c5_dp_missing": dict(n=64, d=10, m=8, t=3, q=3),
    "c1_bgplvm_toy": dict(n=40, d=5, m=6, q=4),
    # the SVI loop at c6's widths (its 1024-row minibatches drawn with
    # replacement from a 112-row train split)
    "c6_svi_bigN": dict(n=128),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_run_end_to_end_gives_the_references_keys(name, tmp_path):
    cfg = dataclasses.replace(config.get(name), **TINY[name])
    data = None
    if name == "c5_dp_missing":   # the JAX package's draw, passed across
        data = np.asarray(jsyn.mocap_like(jax.random.PRNGKey(0), n=cfg.n,
                                          d=cfg.d)[0])
    result = runner.run(cfg, steps=4, device="cpu", dtype=torch.float64,
                        data=data, out=str(tmp_path), log_every=3)
    assert set(result) == set(_artifact(name))
    assert config.evaluate_checks("", result) == []     # finite throughout
    assert result["steps"] == 4
    assert json.loads((tmp_path / "result.json").read_text()) == result
    log = [json.loads(line) for line in
           (tmp_path / "train.jsonl").read_text().splitlines()]
    # whole chunks: 4 steps at 3 a chunk run 6
    assert [rec["step"] for rec in log] == [2, 5]
    if name == "c5_dp_missing":
        assert result["imputation_rows"] == 8
        assert result["data"] == "given:mocap"
    elif name == "c6_svi_bigN":
        assert result["imputation_rows"] == 16 and result["batch"] == 1024
        assert (tmp_path / "params.npz").exists()
    else:
        assert len(result["ard_weights"]) == cfg.q


def test_c7_run_gives_every_gated_metric(tmp_path):
    """The staged c7 path at n=256, 40 steps, 32 rows a step, f64: the
    reference's result keys, every gated metric present and finite, the
    stage boundaries and the raw parameters written, and the planted
    groups' labels from the generator's split of D=32."""
    cfg = dataclasses.replace(config.get("c7_dp_svi"), n=256)
    result = runner.run(cfg, steps=40, device="cpu", dtype=torch.float64,
                        out=str(tmp_path), batch=32, impute_steps=2)
    assert set(result) == set(_artifact("c7_dp_svi"))
    assert config.evaluate_checks("", result) == []     # finite throughout
    for key in config.CHECKS["c7_dp_svi"]:
        assert math.isfinite(result[key]), key
    assert result["imputation_rows"] == runner.GROUPED_TEST_ROWS
    assert result["batch"] == 32 and result["num_groups"] == 4
    assert runner.grouped_dims_per_group(32) == (8, 8, 8, 8)
    assert sorted(os.listdir(tmp_path / "stages")) == [
        "stage1_split.npz", "stage2_warm.npz", "stage2b_assign.npz"]
    exported = load_npz(str(tmp_path / "params.npz"))
    assert exported["u_lam"].shape == (cfg.t, cfg.m, cfg.m)
    with pytest.raises(ValueError, match="staged DP-SVI"):
        runner.run(cfg, steps=40, device="cpu", dtype=torch.float64,
                   stream=True, out=str(tmp_path))


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                        "streamed"])
def test_c8_run_gives_every_key_of_the_reference(stream, tmp_path):
    """The amortized c8 through the SVI loop at n=128, 8 steps of 32 rows,
    f64, resident and streamed: every key of the reference's result, the
    gated metrics finite, the encoder's raw leaves exported in place of a
    q(X) table; a run resumed from the step-4 checkpoint ends on the
    uninterrupted run's bits."""
    cfg = dataclasses.replace(config.get("c8_amortized_svi"), n=128)
    kw = dict(steps=8, device="cpu", dtype=torch.float64, batch=32,
              log_every=2, ckpt_every=4, stream=stream)
    result = runner.run(cfg, out=str(tmp_path / "a"), **kw)
    want = set(_artifact("c8_amortized_svi"))
    assert want <= set(result)
    assert set(result) - want == ({"streamed", "native_loader",
                                   "feed_wait_ms_per_chunk"} if stream
                                  else set())
    assert config.evaluate_checks("", result) == []     # finite throughout
    for key in config.CHECKS["c8_amortized_svi"]:
        assert math.isfinite(result[key]), key
    assert result["imputation_rows"] == 16 and result["batch"] == 32
    exported = load_npz(str(tmp_path / "a" / "params.npz"))
    assert "qx_mean" not in exported and {
        "enc_mean", "enc_wlin", "enc_w1", "enc_ws"} <= set(exported)
    (tmp_path / "b" / "ckpt").mkdir(parents=True)
    os.replace(tmp_path / "a" / "ckpt" / "ckpt_4.pt",
               tmp_path / "b" / "ckpt" / "ckpt_4.pt")
    resumed = runner.run(cfg, out=str(tmp_path / "b"), resume=True,
                         impute_steps=2, **kw)
    assert resumed["elbo"] == result["elbo"]
    again = load_npz(str(tmp_path / "b" / "params.npz"))
    for k, v in exported.items():
        assert np.array_equal(again[k], v), k


def test_main_check_exits_by_the_gates(monkeypatch, tmp_path, capsys):
    argv = ["c1_bgplvm_toy", "--device", "cpu", "--f64", "--n", "40",
            "--steps", "2", "--log-every", "1", "--out", str(tmp_path),
            "--check"]
    monkeypatch.setitem(config.CHECKS, "c1_bgplvm_toy",
                        {"elbo": (">=", -1e30), "steps": ("<=", 2.0)})
    assert runner.main(argv) == 0
    assert "all 2 regression gates pass" in capsys.readouterr().out
    monkeypatch.setitem(config.CHECKS, "c1_bgplvm_toy",
                        {"elbo": [(">=", -1e30), ("<=", -1e29)]})
    assert runner.main(argv) == 1
    assert "FAIL elbo:" in capsys.readouterr().out
    assert runner.main(argv[:-1]) == 0           # no --check, no gates


def test_main_seed_draws_anew(tmp_path):
    """--seed replaces the config's seed: the run is the one `run` gives
    for that seed, and another draw than the config's."""
    cfg = dataclasses.replace(config.get("c1_bgplvm_toy"), n=40)
    argv = ["c1_bgplvm_toy", "--device", "cpu", "--f64", "--n", "40",
            "--steps", "2", "--log-every", "1"]
    elbos = {}
    for seed in (0, 3):
        out = tmp_path / str(seed)
        assert runner.main(argv + ["--seed", str(seed), "--out",
                                   str(out)]) == 0
        elbos[seed] = json.loads((out / "result.json").read_text())["elbo"]
    want = runner.run(dataclasses.replace(cfg, seed=3), steps=2,
                      device="cpu", dtype=torch.float64, log_every=1)
    assert elbos[3] == want["elbo"] and elbos[3] != elbos[0]


def test_f64_is_refused_on_the_card():
    cfg = config.get("c4_dp_mocap")
    with pytest.raises(ValueError, match="float32 only"):
        runner.run(cfg, steps=1, device="cuda", dtype=torch.float64)


def _reference_runner():
    """The reference's experiments/run.py as a module (its imports of JAX
    are inside main)."""
    spec = importlib.util.spec_from_file_location(
        "reference_run", ROOT / "experiments" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_c3_run_on_the_references_data_and_init(tmp_path):
    """c3 at n=48 (42 training rows, every 8th of the 48 held out) for a
    few steps of its three restarts, f64, given the reference runner's
    draw and first init (experiments/run.py:168-181, 237-242)."""
    cfg = dataclasses.replace(config.get("c3_mrd_twoview"), n=48)
    mcfg = jmrd.Config(num_latent=cfg.q, num_inducing=cfg.m, num_views=2)

    @jax.jit
    def reference(key):
        Y1, Y2, _ = jsyn.two_view(key, n=cfg.n, d1=8, d2=8, q_shared=2,
                                  private_weight=0.5, dtype=jnp.float64)
        keep = np.flatnonzero(np.arange(cfg.n) % 8 != 7)
        return (Y1, Y2), jmrd.init_params(key, [Y1[keep], Y2[keep]], mcfg)

    views, init = jax.tree.map(np.asarray, reference(jax.random.PRNGKey(0)))
    result = runner.run(cfg, steps=4, device="cpu", dtype=torch.float64,
                        data=views, params=init, out=str(tmp_path),
                        log_every=2)
    assert set(result) == set(_artifact("c3_mrd_twoview"))
    assert result["data"] == "given:two_view"
    assert len(result["restart_elbos"]) == 3
    assert config.evaluate_checks("", result) == []     # finite throughout
    for key in config.CHECKS["c3_mrd_twoview"]:
        assert math.isfinite(result[key]), key
    # the holdout: rows 7, 15, ... are test rows, and keep the scale of the
    # whole series (the baseline predicts the training mean of view 1)
    test = np.arange(cfg.n) % 8 == 7
    Y2 = views[1]
    base = np.mean((Y2[~test].mean(axis=0) - Y2[test]) ** 2)
    np.testing.assert_allclose(result["cross_view_mse_baseline"], base,
                               rtol=1e-12)
    # the raw parameters are exported, views included, and their ARD
    # weights give the result's signature by the reference's function
    exported = load_npz(str(tmp_path / "params.npz"))
    assert {"qx_mean", "raw_qx_var", "views/0/z", "views/1/raw_ard"} <= set(
        exported)
    rel = np.logaddexp(0.0, np.stack([exported[f"views/{i}/raw_ard"]
                                      for i in range(2)]))
    np.testing.assert_allclose(result["ard_relevance"], rel, atol=1e-6)
    want = _reference_runner().ard_cross_private_ratio(rel)
    assert runner.ard_cross_private_ratio(rel) == want
    np.testing.assert_allclose(result["ard_cross_private_ratio"], want,
                               rtol=1e-12)


def test_load_data_two_view_big_is_the_references_draw():
    """c9's dataset: n + 512 rows of the RFF two-view draw on the config's
    key, each view standardized over all of them (the held-out rows are the
    last 512), against `synthetic.two_view_big` of the JAX package."""
    cfg = dataclasses.replace(config.get("c9_mrd_svi_bigN"), n=600 - 512)
    Ys, tag = runner.load_data(cfg, torch.float64, "cpu")
    assert tag == "synthetic:two_view_big"
    want = jsyn.two_view_big(jax.random.PRNGKey(cfg.seed), n=600, d1=32,
                             d2=32, q_shared=2, q_private=1,
                             private_weight=0.5, dtype=jnp.float64)
    assert len(Ys) == 2
    for got, w in zip(Ys, want[:2]):
        assert tuple(got.shape) == (600, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("staged", [True, False], ids=["staged",
                                                       "one_phase_streamed"])
def test_c9_run_gives_every_key_of_the_reference(staged, monkeypatch,
                                                  tmp_path):
    """c9 at n=256 for 16 steps of 32 rows, f64: through the two-phase
    recipe (its boundary in `stages`, then the resume from it to the same
    bits), or in one phase with the streamed feed (`--staged off
    --stream`); every key of the reference's result, every gated metric
    present and finite, the raw parameters exported with their views. The
    cross-view inference takes 20 steps here (300 in a run)."""
    monkeypatch.setattr(runner, "MRD_SVI_PREDICT_STEPS", 20)
    cfg = dataclasses.replace(config.get("c9_mrd_svi_bigN"), n=256)
    kw = dict(steps=16, device="cpu", dtype=torch.float64, batch=32,
              log_every=4, staged=staged, stream=not staged)
    result = runner.run(cfg, out=str(tmp_path / "a"), **kw)
    want = set(_artifact("c9_mrd_svi_bigN"))
    if staged:
        assert set(result) == want
        assert (result["phase_a_steps"], result["phase_b_steps"]) == (8, 8)
    else:
        assert set(result) - want == {"streamed", "native_loader",
                                      "feed_wait_ms_per_chunk"}
        assert want - set(result) == {
            "phase_a_steps", "phase_b_steps", "recipe", "hot_lr",
            "reset_variance", "reset_noise"}
    assert config.evaluate_checks("", result) == []     # finite throughout
    for key in config.CHECKS["c9_mrd_svi_bigN"]:
        assert math.isfinite(result[key]), key
    assert result["batch"] == 32
    exported = load_npz(str(tmp_path / "a" / "params.npz"))
    assert {"qx_mean", "raw_qx_var", "views/0/u_mean",
            "views/1/raw_u_scale"} <= set(exported)
    assert exported["qx_mean"].shape == (256, cfg.q)
    if staged:
        (tmp_path / "b" / "stages").mkdir(parents=True)
        os.replace(tmp_path / "a" / "stages" / "phaseA.npz",
                   tmp_path / "b" / "stages" / "phaseA.npz")
        resumed = runner.run(cfg, out=str(tmp_path / "b"), resume=True, **kw)
        assert resumed["elbo"] == result["elbo"]
        again = load_npz(str(tmp_path / "b" / "params.npz"))
        for k, v in exported.items():
            assert np.array_equal(again[k], v), k


def test_c9_staged_refuses_the_single_phase_options(tmp_path):
    cfg = dataclasses.replace(config.get("c9_mrd_svi_bigN"), n=256)
    for kw in (dict(stream=True), dict(ckpt_every=4), dict(stop_after=4)):
        with pytest.raises(ValueError, match="staged MRD-SVI"):
            runner.run(cfg, steps=8, device="cpu", dtype=torch.float64,
                       out=str(tmp_path), **kw)


def _write_amc(path, Y):
    """Y (N, 6) as an AMC file of three bones, plus a constant channel on
    the last (which preprocessing drops)."""
    Y = np.c_[Y, np.full(len(Y), 7.5)]
    mocap.write_amc(str(path), Y, [("root", 2), ("lfemur", 2),
                                   ("rfemur", 3)])


def test_data_dir_reads_the_files_and_plots(tmp_path):
    """--data-dir: c2 reads DataTrn.txt / DataTrnLbls.txt and c4 the first
    .amc file of the directory; N (c2) and D (c4) come from the files, the
    tags name them, and --plots draws the reference's PNGs."""
    data = tmp_path / "data"
    data.mkdir()
    r = np.random.default_rng(5)
    oil = r.normal(size=(60, 12))
    np.savetxt(data / "DataTrn.txt", oil)
    np.savetxt(data / "DataTrnLbls.txt", np.eye(3)[r.integers(0, 3, 60)])
    Y_amc = r.normal(size=(70, 6))
    _write_amc(data / "b.amc", Y_amc)
    _write_amc(data / "a.amc", Y_amc[:66])       # the first by name
    base = ["--steps", "2", "--device", "cpu", "--f64", "--log-every", "1",
            "--data-dir", str(data), "--plots"]
    for name, tag, pngs in (
            ("c2_sparse_oil", "file:oil_flow", {"latent", "ard"}),
            ("c4_dp_mocap", "amc:a.amc",
             {"latent", "ard", "assignments", "sticks"})):
        out = tmp_path / name
        assert runner.main([name, *base, "--out", str(out)]) == 0
        result = json.loads((out / "result.json").read_text())
        assert result["data"] == tag
        assert {p.stem for p in out.glob("*.png")} == pngs
        params = load_npz(str(out / "params.npz"))
        if name == "c2_sparse_oil":
            assert params["qx_mean"].shape == (60, 10)
        else:                       # 6 varying channels, the constant gone
            assert params["qx_mean"].shape[0] == 66
            assert params["phi"].shape == (6, 20)
    # the loaded Y is the written data, standardized
    cfg = config.get("c2_sparse_oil")
    Y, _ = runner.load_data(cfg, torch.float64, "cpu", str(data))
    np.testing.assert_allclose(Y.numpy(), (oil - oil.mean(0)) / oil.std(0),
                               rtol=1e-12, atol=1e-12)
    Y, _ = runner.load_data(config.get("c4_dp_mocap"), torch.float64, "cpu",
                            str(data))
    y = Y_amc[:66]
    np.testing.assert_allclose(Y.numpy(), (y - y.mean(0)) / y.std(0),
                               rtol=1e-12, atol=1e-12)


def test_ard_lr_and_debug_nans_reach_the_training(monkeypatch, tmp_path):
    """--ard-lr is the optimizer's ard_lr; --debug-nans trains in autograd's
    anomaly mode and raises at a non-finite loss (a NaN in the initial
    latents of a full-batch run; the injected NaN of an SVI chunk)."""
    seen = []

    def recording(*args, **kw):
        seen.append((kw["ard_lr"], torch.is_anomaly_enabled()))
        return gp_optimizer(*args, **kw)

    gp_optimizer = runner.gp_optimizer
    monkeypatch.setattr(runner, "gp_optimizer", recording)
    argv = ["c1_bgplvm_toy", "--device", "cpu", "--f64", "--n", "40",
            "--steps", "2", "--log-every", "1", "--out", str(tmp_path)]
    assert runner.main(argv + ["--ard-lr", "0.05", "--debug-nans"]) == 0
    assert runner.main(argv) == 0
    assert seen == [(0.05, True), (None, False)]
    assert not torch.is_anomaly_enabled()

    cfg = dataclasses.replace(config.get("c1_bgplvm_toy"), n=40)
    Y, _ = runner.load_data(cfg, torch.float64, "cpu")
    init = {k: v.detach().numpy().copy() for k, v in runner.MODELS[
        "bgplvm"].init_params(prng.PRNGKey(0), Y, runner._model_config(
            cfg, None)).items()}
    init["qx_mean"][3, 1] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        runner.run(cfg, steps=2, device="cpu", dtype=torch.float64,
                   log_every=1, params=init, debug_nans=True)
    c6 = dataclasses.replace(config.get("c6_svi_bigN"), n=128)
    with pytest.raises(FloatingPointError, match="at step 2"):
        runner.run(c6, steps=4, device="cpu", dtype=torch.float64,
                   batch=32, log_every=2, inject_nonfinite_at=2,
                   debug_nans=True)


def test_plots_without_matplotlib_fail_before_training(monkeypatch,
                                                       tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--plots needs matplotlib"):
        runner.main(["c1_bgplvm_toy", "--device", "cpu", "--f64", "--n",
                     "40", "--steps", "2", "--plots", "--out",
                     str(tmp_path)])
    assert not (tmp_path / "train.jsonl").exists()
