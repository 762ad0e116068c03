"""The port's host-streamed minibatch feed (`data/stream.py` with its native
gather `csrc/stream_loader.cpp`, `make_svi_natgrad_step(streaming=True)`,
`train.loop.make_streaming_scan_fn`, the runner's `--stream`) against the
JAX package's, on the CPU in float64:

- the native gather equals the port's `NumpyLoader` and the reference's on
  repeated and boundary rows, and a row out of range raises at `wait()`;
- `ChunkStream` gives the reference's indices and rows bit for bit, and
  `skip_chunks` drops whole chunks of draws;
- the streamed step is the resident step, bit for bit, at equal rows, and
  a chunk of `make_streaming_scan_fn` is the resident loop;
- two streamed chunks of three steps equal the reference's
  `make_streaming_scan_fn` on the same (idx, y) at rtol 1e-8 (the JAX
  oracle is jitted once, at N=48, B=8, M=6, Q=2, D=4);
- the runner's `--stream` resumes bit for bit and refuses a resume off
  the chunk multiple.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import stream as jstream
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import stream
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.models import svi_gplvm
from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz
from dp_gp_lvm_tpu_torch.train.loop import (
    TrainState,
    gp_optimizer,
    make_streaming_scan_fn,
)

N, B, M, Q, D = 48, 8, 6, 2, 4
CHUNK, CHUNKS = 3, 2
SMALL = ["c6_svi_bigN", "--device", "cpu", "--f64", "--n", "128",
         "--batch", "32", "--steps", "8", "--stream"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Y (N, D) float32 values from a numpy seed, written as the loader's
    file."""
    Y = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("stream") / "y.f32")
    stream.write_rows(path, Y)
    return path, Y


def _model(Y):
    """(config, initial params as numpy) of the reference, off its init
    manifold so that no check is vacuous."""
    cfg = jsvi.Config(num_latent=Q, num_inducing=M, batch=B)
    p0 = jsvi.init_params(jax.random.PRNGKey(1), jnp.asarray(Y, jnp.float64),
                          cfg)
    p0 = jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), p0)
    return cfg, {k: np.asarray(v) for k, v in p0.items()}


def _chunks(path):
    """CHUNKS chunks of the reference's stream (seed 7) over the file."""
    with jstream.ChunkStream(jstream.NumpyLoader(path, N, D), batch=B,
                             chunk=CHUNK, seed=7) as cs:
        return [tuple(a.copy() for a in cs.next_chunk())
                for _ in range(CHUNKS)]


@pytest.fixture(scope="module")
def ref(dataset):
    """The reference's streamed natural-gradient chunks on those rows."""
    path, Y = dataset
    cfg, p0 = _model(Y)
    chunks = _chunks(path)
    opt = jloop.gp_optimizer(p0, lr=3e-3, ngd_lr=1.0,
                             decay_steps=CHUNK * CHUNKS)
    step = jsvi.make_svi_natgrad_step(cfg, N, opt, rho=0.2, streaming=True)
    scan_chunk = jloop.make_streaming_scan_fn(step)
    state = jloop.init_state(jax.tree.map(jnp.asarray, p0), opt)
    losses = []
    for k, (idx, y) in enumerate(chunks):
        rngs = jax.random.split(jax.random.PRNGKey(k), CHUNK)
        state, ls = scan_chunk(state, rngs, jnp.asarray(idx),
                               jnp.asarray(y, jnp.float64))
        losses.append(np.asarray(ls))
    return dict(p0=p0, chunks=chunks, losses=np.concatenate(losses),
                trained={k: np.asarray(v) for k, v in state.params.items()})


def test_native_gather_equals_both_numpy_gathers(dataset):
    path, Y = dataset
    assert stream.native_available()
    assert stream.library_path().exists()
    idx = np.random.Generator(np.random.Philox(1)).integers(
        0, N, size=200, dtype=np.int32)
    idx[:4] = [0, N - 1, 0, N - 1]                 # boundaries, repeated
    outs = {}
    for name, loader in (("native", stream.StreamLoader(path, N, D)),
                         ("numpy", stream.NumpyLoader(path, N, D)),
                         ("reference", jstream.NumpyLoader(path, N, D))):
        outs[name] = np.empty((idx.size, D), np.float32)
        loader.request(idx, outs[name])
        loader.wait()
        loader.close()
    np.testing.assert_array_equal(outs["native"], Y[idx])
    np.testing.assert_array_equal(outs["native"], outs["numpy"])
    np.testing.assert_array_equal(outs["native"], outs["reference"])


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_row_out_of_range_raises_at_wait(dataset, kind):
    path, _ = dataset
    cls = stream.StreamLoader if kind == "native" else stream.NumpyLoader
    loader = cls(path, N, D)
    loader.request(np.array([0, N], np.int32), np.empty((2, D), np.float32))
    with pytest.raises(IndexError):
        loader.wait()
    loader.close()


def test_chunk_stream_equals_reference_and_skips_chunks(dataset):
    path, Y = dataset
    with jstream.ChunkStream(jstream.NumpyLoader(path, N, D), batch=B,
                             chunk=CHUNK, seed=7) as cs:
        want = [tuple(a.copy() for a in cs.next_chunk()) for _ in range(3)]
    with stream.ChunkStream(stream.open_loader(path, N, D), batch=B,
                            chunk=CHUNK, seed=7) as cs:
        got = [tuple(a.copy() for a in cs.next_chunk()) for _ in range(3)]
    for (gi, gy), (wi, wy) in zip(got, want):
        assert gi.dtype == np.int32 and gi.shape == (CHUNK, B)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gy, Y[gi])
    # on a device it gives tensors that own their memory
    with stream.ChunkStream(stream.open_loader(path, N, D), batch=B,
                            chunk=CHUNK, seed=7, skip_chunks=2,
                            device="cpu") as cs:
        idx, y = cs.next_chunk()
        cs.next_chunk()                            # refills the first buffer
    assert idx.dtype == torch.int64 and y.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want[2][0])
    np.testing.assert_array_equal(y.numpy(), want[2][1])


def _port_step(p0, streaming):
    p = params_from_jax(p0, "cpu")
    cfg = svi_gplvm.Config(num_latent=Q, num_inducing=M, batch=B)
    opt = gp_optimizer(p, lr=3e-3, ngd_lr=1.0, decay_steps=CHUNK * CHUNKS)
    return p, svi_gplvm.make_svi_natgrad_step(cfg, N, opt, rho=0.2,
                                              streaming=streaming)


def test_streamed_step_is_the_resident_step(dataset, ref):
    _, Y = dataset
    Yt = torch.tensor(Y, dtype=torch.float64)
    idx = torch.tensor([5, 5, 0, N - 1, 33, 2, 17, 0])
    p_res, res = _port_step(ref["p0"], streaming=False)
    p_str, st = _port_step(ref["p0"], streaming=True)
    for t in range(2):
        assert float(res(t, idx, Yt)) == float(st(t, (idx, Yt[idx])))
    for k in p_res:
        np.testing.assert_array_equal(p_res[k].detach().numpy(),
                                      p_str[k].detach().numpy(), err_msg=k)


def test_scan_chunk_is_the_resident_loop(dataset, ref):
    _, Y = dataset
    Yt = torch.tensor(Y, dtype=torch.float64)
    idx, y = ref["chunks"][0]
    p_res, res = _port_step(ref["p0"], streaming=False)
    want = [float(res(t, torch.from_numpy(idx[t]).long(), Yt))
            for t in range(CHUNK)]
    p_str, st = _port_step(ref["p0"], streaming=True)
    state = TrainState(None)
    state, losses = make_streaming_scan_fn(st)(
        state, torch.from_numpy(idx).long(),
        torch.tensor(y, dtype=torch.float64))
    assert state.step == CHUNK
    assert losses.tolist() == want
    for k in p_res:
        np.testing.assert_array_equal(p_res[k].detach().numpy(),
                                      p_str[k].detach().numpy(), err_msg=k)


def test_streamed_chunks_match_reference(ref):
    p, st = _port_step(ref["p0"], streaming=True)
    scan_chunk = make_streaming_scan_fn(st)
    state, losses = TrainState(None), []
    for idx, y in ref["chunks"]:
        state, ls = scan_chunk(state, torch.from_numpy(idx).long(),
                               torch.tensor(y, dtype=torch.float64))
        losses.append(ls)
    np.testing.assert_allclose(torch.cat(losses).numpy(), ref["losses"],
                               rtol=1e-8)
    for k, v in ref["trained"].items():
        np.testing.assert_allclose(p[k].detach().numpy(), v, rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def _run(out, *extra):
    assert runner.main(SMALL + ["--out", str(out), *extra]) == 0
    return json.loads((out / "result.json").read_text())


def test_runner_stream_resumes_bit_for_bit(tmp_path, capsys):
    straight, stopped = tmp_path / "straight", tmp_path / "interrupted"
    res_a = _run(straight, "--log-every", "2")
    assert res_a["streamed"] is True and res_a["native_loader"] is True
    assert res_a["feed_wait_ms_per_chunk"] >= 0.0
    _run(stopped, "--log-every", "2", "--stop-after", "4",
         "--ckpt-every", "2")
    capsys.readouterr()
    res_b = _run(stopped, "--log-every", "2", "--resume", "--ckpt-every",
                 "2")
    assert "resumed at step 4" in capsys.readouterr().out
    assert res_a["elbo"] == res_b["elbo"]
    a, b = (load_npz(str(d / "params.npz")) for d in (straight, stopped))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a checkpoint at step 2 is off the multiple of a chunk of 4
    at2 = tmp_path / "at2"
    _run(at2, "--log-every", "2", "--stop-after", "2", "--ckpt-every", "2")
    with pytest.raises(SystemExit, match=r"--resume at step 2: the "
                       r"streaming Philox fast-forward needs a "
                       r"chunk-multiple checkpoint \(chunk=4\)"):
        runner.main(SMALL + ["--out", str(at2), "--log-every", "4",
                             "--resume"])
