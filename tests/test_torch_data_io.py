"""The port's file loaders against the JAX package's, on the CPU: the AMC
parser (Python and native) on the committed `tests/fixtures/demo.amc`,
exactly; the native parser's hard errors (a reordered bone) and dropped
short trailing frame, and that it refuses to answer where it cannot be
built; `load_oil_flow` on the committed oil-flow fixtures, without the
label file and on its fallback (the data at 1e-12, labels and tags
equal); `load_mocap` from a file and on its fallback; `parse_asf`,
`parse_amc_frames` and `fk_sequence` on `demo.asf` / `demo.amc` at
1e-12. The reference's values come from one module-scoped fixture."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import asf as jasf
from dp_gp_lvm_tpu.data import mocap as jmocap
from dp_gp_lvm_tpu.data import oil_flow as joil
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data import asf, mocap, native_io, oil_flow

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
AMC = os.path.join(FIXTURES, "demo.amc")
ASF = os.path.join(FIXTURES, "demo.asf")


@pytest.fixture(scope="module")
def ref():
    sk = jasf.parse_asf(ASF)
    frames = jasf.parse_amc_frames(AMC)
    Y_oil, lbl_oil, tag_oil = joil.load_oil_flow(FIXTURES)
    Y_fb, lbl_fb, tag_fb = joil.load_oil_flow(None)
    Y_mf, tag_mf = jmocap.load_mocap(AMC, subsample=2)
    Y_mc, tag_mc = jmocap.load_mocap(None, n=64, d=10,
                                     rng=jax.random.PRNGKey(3))
    return dict(amc=jmocap.parse_amc(AMC), frames=frames,
                fk=jasf.fk_sequence(sk, frames), joints=sk.joint_names(),
                oil=(np.asarray(Y_oil), np.asarray(lbl_oil), tag_oil),
                oil_fallback=(np.asarray(Y_fb), np.asarray(lbl_fb), tag_fb),
                mocap_file=(np.asarray(Y_mf), tag_mf),
                mocap_fallback=(np.asarray(Y_mc), tag_mc))


def _write_amc(path, frames):
    """frames: a list of [(bone, values), ...]."""
    with open(path, "w") as fh:
        fh.write(":FULLY-SPECIFIED\n:DEGREES\n")
        for i, frame in enumerate(frames, 1):
            fh.write(f"{i}\n")
            for bone, values in frame:
                fh.write(" ".join([bone, *map(str, values)]) + "\n")
    return str(path)


def test_parse_amc_matches_reference_python_and_native(ref):
    data, names = mocap.parse_amc(AMC)
    np.testing.assert_array_equal(data, ref["amc"][0])
    assert names == ref["amc"][1]
    assert native_io.available()
    np.testing.assert_array_equal(native_io.parse_amc_native(AMC), data)
    lib = native_io.library_path(native_io.SOURCE, "amc_parser",
                                 native_io.GXX_FLAGS)
    assert lib.parent.name == "kernels" and lib.exists()


def test_native_parser_errors_and_short_frames(tmp_path):
    good = [("root", [0.5, 1.0]), ("lhip", [2.0, 3.0, 4.0])]
    swapped = [good[1], good[0]]
    with pytest.raises(ValueError, match="bone order"):
        native_io.parse_amc_native(_write_amc(tmp_path / "r.amc",
                                              [good, swapped]))
    reshaped = [good[0], ("lhip", [2.0, 3.0])]
    with pytest.raises(ValueError):
        native_io.parse_amc_native(_write_amc(tmp_path / "w.amc",
                                              [good, good, reshaped, good]))
    short = _write_amc(tmp_path / "s.amc", [good, good, good[:1]])
    assert native_io.parse_amc_native(short).shape == (2, 5)


def test_write_amc_reads_back_to_the_bit(tmp_path):
    r = np.random.default_rng(2)
    Y = r.normal(size=(9, 5)) * 10.0 ** r.integers(-8, 8, (9, 5))
    path = mocap.write_amc(str(tmp_path / "w.amc"), Y,
                           [("root", 3), ("thorax", 2)])
    data, names = mocap.parse_amc(path)
    np.testing.assert_array_equal(data, Y)
    np.testing.assert_array_equal(native_io.parse_amc_native(path), Y)
    assert names == ["root:0", "root:1", "root:2", "thorax:0", "thorax:1"]


def test_native_parser_refuses_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_BUILD_ERR", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ on it
    assert not native_io.available()
    with pytest.raises(RuntimeError, match="native build failed"):
        native_io.parse_amc_native(AMC)


def test_load_oil_flow_matches_reference(ref, tmp_path):
    Y, labels, tag = oil_flow.load_oil_flow(FIXTURES, device="cpu")
    assert Y.is_contiguous()
    np.testing.assert_allclose(Y.numpy(), ref["oil"][0], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(labels.numpy(), ref["oil"][1])
    assert tag == ref["oil"][2] == "file:oil_flow"
    shutil.copy(os.path.join(FIXTURES, "DataTrn.txt"), tmp_path)
    Y2, labels2, _ = oil_flow.load_oil_flow(str(tmp_path), device="cpu")
    assert torch.equal(Y2, Y) and not labels2.any()
    Y, labels, tag = oil_flow.load_oil_flow(None, device="cpu")
    np.testing.assert_allclose(Y.numpy(), ref["oil_fallback"][0],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(labels.numpy(), ref["oil_fallback"][1])
    assert tag == ref["oil_fallback"][2] == "synthetic:oil_flow_like"
    assert oil_flow.load_oil_flow(str(tmp_path / "none"),
                                  device="cpu")[2] == tag


def test_load_mocap_matches_reference(ref, tmp_path):
    Y, tag = mocap.load_mocap(AMC, subsample=2, device="cpu")
    np.testing.assert_allclose(Y.numpy(), ref["mocap_file"][0], rtol=1e-12,
                               atol=1e-12)
    # row-major, as the CUDA kernels take Y (they refuse other strides)
    assert Y.is_contiguous()
    assert tag == ref["mocap_file"][1] == "amc:demo.amc"
    Y, tag = mocap.load_mocap(None, n=64, d=10, rng=prng.PRNGKey(3),
                              device="cpu")
    np.testing.assert_allclose(Y.numpy(), ref["mocap_fallback"][0],
                               rtol=1e-12, atol=1e-12)
    assert tag == ref["mocap_fallback"][1]
    # preprocess drops a constant channel before standardizing
    raw = np.c_[np.arange(6.0), np.full(6, 2.5), np.arange(6.0) ** 2]
    out = mocap.preprocess(raw)
    assert out.shape == (6, 2)
    np.testing.assert_allclose(out.std(axis=0), 1.0, rtol=1e-12)


def test_asf_forward_kinematics_matches_reference(ref):
    sk = asf.parse_asf(ASF)
    frames = asf.parse_amc_frames(AMC)
    assert frames == ref["frames"]
    assert sk.joint_names() == ref["joints"]
    np.testing.assert_allclose(asf.fk_sequence(sk, frames), ref["fk"],
                               rtol=1e-12, atol=1e-12)
    _, segments = asf.fk_frame(sk, frames[0])
    assert len(segments) == len(sk.bones)
