"""qsnap in the port against the JAX package: the plain torch versions are
bit-equal to ``repro.kernels.ref`` and to ``repro.ckpt.compression``, the
port's host codec (no ``ml_dtypes``) is byte-equal to the reference's, and
``qsnap_encode_chunks`` payloads are byte-equal across the two packages.
The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import compression as jcomp
from repro.kernels import qsnap as jqsnap
from repro.kernels import ref as jref
from repro_torch.ckpt import compression as tcomp
from repro_torch.kernels import qsnap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ties_block(scale: float = 1.0) -> np.ndarray:
    """A 256-block whose x/scale hits exact .5 ties (round half to even):
    absmax 127 gives scale 127 * f32(1/127) == 1.0 exactly, and k + 0.5
    is exact in f32 and bf16 for k < 127."""
    half = np.arange(127, dtype=np.float32) + np.float32(0.5)
    blk = np.concatenate([[127.0], half, -half, [0.0]]).astype(np.float32)
    return blk * np.float32(scale)


def _case(name: str) -> np.ndarray:
    """f32 values of each test case (bf16 cases are rounded from these)."""
    rng = np.random.default_rng(11)
    if name == "ragged":
        return (rng.standard_normal(1000) * 3).astype(np.float32)
    if name == "zero_block":
        x = (rng.standard_normal(768) * 2).astype(np.float32)
        x[256:512] = 0.0
        return x
    if name == "ties":
        return np.concatenate([_ties_block(), _ties_block(4.0)])
    if name == "tiny":
        return (rng.standard_normal(256) * 1e-30).astype(np.float32)
    return (rng.standard_normal(4096) * 5).astype(np.float32)


CASES = ["random", "ragged", "zero_block", "ties", "tiny"]
DTYPES = ["float32", "bfloat16"]


def _inputs(name: str, dtype: str):
    """(numpy array for the reference, torch tensor for the port)."""
    x = _case(name)
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return xb, torch.from_numpy(xb.view(np.int16).copy()).view(
            torch.bfloat16)
    return x, torch.from_numpy(x.copy())


def _pad(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros((-x.size) % 256, x.dtype)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_plain_quantize_bitequal_to_reference(name, dtype):
    xn, xt = _inputs(name, dtype)
    codes, scales = qsnap.qsnap_quantize_plain(xt)
    hc, hs = jcomp.quantize_int8(xn)
    np.testing.assert_array_equal(codes.numpy(), hc)
    assert scales.numpy().tobytes() == hs.tobytes()
    rc, rs = jref.qsnap_ref(jnp.asarray(_pad(xn)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
    assert scales.numpy().tobytes() == np.asarray(rs).tobytes()
    if name == "ties":                   # half-to-even really was exercised
        assert set(np.unique(np.abs(hc))) >= {0, 2, 4}
    if name == "zero_block":
        assert hs[1] == 1.0 and not hc[256:512].any()


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_plain_dequantize_bitequal_to_reference(name, out_dtype):
    xn, _ = _inputs(name, "float32")
    hc, hs = jcomp.quantize_int8(xn)
    out = qsnap.qsnap_dequantize_plain(
        torch.from_numpy(hc.copy()), torch.from_numpy(hs.copy()),
        getattr(torch, out_dtype))
    want = np.asarray(jref.qsnap_dequant_ref(
        jnp.asarray(hc), jnp.asarray(hs), getattr(jnp, out_dtype)))
    got = out.view(torch.int16).numpy() if out_dtype == "bfloat16" \
        else out.numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("codec", ["raw", "zlib", "int8", "int8+zlib"])
@pytest.mark.parametrize("dtype", DTYPES + ["int32"])
def test_host_codec_without_ml_dtypes_matches_reference(codec, dtype):
    """The port's host codec, reading bf16 as 16-bit words, encodes and
    decodes exactly the reference's bytes."""
    x = _case("ragged")
    a = (x * 100).astype(np.int32) if dtype == "int32" \
        else x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else x.dtype)
    data = a.tobytes()
    enc = tcomp.encode(data, dtype, codec)
    assert enc == jcomp.encode(data, a.dtype, codec)
    assert tcomp.decode(enc, dtype, codec) == jcomp.decode(enc, a.dtype,
                                                           codec)


def test_encode_chunks_payloads_byte_equal_to_jax():
    leaves = [_inputs("random", "float32"), _inputs("ragged", "bfloat16"),
              _inputs("ties", "float32"), _inputs("zero_block", "bfloat16"),
              (np.arange(6, dtype=np.int32).reshape(2, 3),
               torch.arange(6, dtype=torch.int32).reshape(2, 3)),
              (np.asarray(7, np.int32), torch.tensor(7, dtype=torch.int32))]
    ours = qsnap.qsnap_encode_chunks([t for _, t in leaves])
    theirs = jqsnap.qsnap_encode_chunks([jnp.asarray(a) for a, _ in leaves])
    assert ours == theirs
    host = [jcomp.encode(a.tobytes(), a.dtype, "int8") for a, _ in leaves]
    assert ours == host


def test_dispatch_takes_plain_version_only_for_cpu_tensors():
    _, xt = _inputs("ragged", "bfloat16")
    before = dict(qsnap.LAUNCHES)
    c1, s1 = qsnap.qsnap_quantize(xt)
    c2, s2 = qsnap.qsnap_quantize_plain(xt)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    assert torch.equal(qsnap.qsnap_dequantize(c1, s1),
                       qsnap.qsnap_dequantize_plain(c1, s1))
    assert qsnap.LAUNCHES == before      # plain versions launch nothing
    with pytest.raises(ValueError, match="CUDA tensor"):
        qsnap.qsnap_quantize_cuda(xt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        qsnap.qsnap_dequantize_cuda(c1, s1)
