"""The port's block-float wavefield codec and snapshot store
(jets_tpu_torch/utils/compression.py) held against jets_tpu.utils.compression
on the CPU: the cases of tests/test_compression.py with the same
parametrizations, each run on the port and held against the JAX package's
function on the same inputs. The codec is exact: the port's bytes are the
JAX package's bytes (native and numpy paths alike), and each package opens
the other's disk stores and reads the same arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jets_tpu.ops.wave import wave_propagator as j_wave_propagator
from jets_tpu.utils import compression as J
from jets_tpu_torch.ops.wave import wave_propagator
from jets_tpu_torch.utils import compression as C

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


@pytest.mark.parametrize("bits,min_snr_db", [(4, 8.0), (8, 34.0),
                                             (12, 58.0), (16, 80.0)])
def test_roundtrip_snr(bits, min_snr_db):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_000).astype(np.float32)
    # smooth wavefield-like signal: strong spatial correlation per block
    x = np.cumsum(x) / 50.0
    buf = C.compress_array(x, bits)
    assert buf == J.compress_array(x, bits)
    y = C.decompress_array(buf, x.shape, bits)
    np.testing.assert_array_equal(y, J.decompress_array(buf, x.shape, bits))
    err = x - y
    snr = 10 * np.log10(np.sum(x**2) / max(np.sum(err**2), 1e-30))
    assert snr > min_snr_db, (bits, snr)
    assert len(buf) == int(4 * x.size / C.compression_ratio(x.size, bits))
    assert C.compression_ratio(x.size, bits) == J.compression_ratio(x.size, bits)


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000])
def test_odd_sizes_and_zero_blocks(bits, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[: n // 3] = 0.0  # leading zeros; whole block zero when n >= 768
    buf = C.compress_array(x, bits)
    assert buf == J.compress_array(x, bits)
    y = C.decompress_array(buf, (n,), bits)
    assert y.shape == (n,)
    np.testing.assert_array_equal(y, J.decompress_array(buf, (n,), bits))
    qmax = (1 << (bits - 1)) - 1
    np.testing.assert_allclose(y, x, atol=float(np.abs(x).max()) / qmax)
    z = np.zeros(n, np.float32)
    np.testing.assert_array_equal(
        C.decompress_array(C.compress_array(z, bits), (n,), bits), z)


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_native_matches_numpy_bytes(bits):
    """The port's C++ codec and its numpy fallback produce IDENTICAL bytes
    (and therefore identical reconstructions), the JAX package's."""
    assert C.native(), "native codec failed to build (g++ present?)"
    rng = np.random.default_rng(3)
    x = (np.cumsum(rng.standard_normal(5000)) / 10).astype(np.float32)
    native = C.compress_array(x, bits)
    fallback = C._compress_np(x.ravel(), bits)
    assert native == fallback == J._compress_np(x.ravel(), bits)
    y_native = C.decompress_array(native, x.shape, bits)
    y_np = C._decompress_np(np.frombuffer(fallback, np.uint8), x.size,
                            bits).reshape(x.shape)
    np.testing.assert_array_equal(y_native, y_np)


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_tiny_blocks_native_matches_numpy(bits):
    """A block whose max |x| lies below qmax / FLT_MAX (a wavefield's quiet
    far side, down to the subnormals) overflows the JAX package's
    ``qmax / max`` to inf, where its native code and numpy fallback round
    differently; the port scales such a block as ``(x / max) * qmax`` in
    both paths, so they agree and keep the block to its quantization step.
    Elsewhere the bytes stay the JAX package's."""
    rng = np.random.default_rng(bits)
    x = (np.cumsum(rng.standard_normal(256 * 6)) / 10).astype(np.float32)
    for k, mx in enumerate((1e-36, 5e-38, 1e-39, 1e-41)):  # blocks 1-4 tiny
        blk = x[256 * (k + 1):256 * (k + 2)]
        blk *= np.float32(mx) / np.max(np.abs(blk))
    native = C.compress_array(x, bits)
    assert native == C._compress_np(x, bits)
    y = C.decompress_array(native, x.shape, bits)
    qmax = (1 << (bits - 1)) - 1
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    for k in range(6):  # half a step, plus the rounding of a subnormal step
        blk, rec = x[256 * k:256 * (k + 1)], y[256 * k:256 * (k + 1)]
        step = float(np.max(np.abs(blk))) / qmax
        assert np.max(np.abs(rec - blk)) <= 0.5 * step * (1 + 1e-3) + qmax * tiny
    for k in (0, 5):  # the ordinary blocks: the JAX package's bytes
        nb = 4 + (256 * bits + 7) // 8
        assert native[nb * k:nb * (k + 1)] == J.compress_array(x[256 * k:256 * (k + 1)], bits)


def test_bad_bits_raises():
    for mod in (C, J):
        with pytest.raises(ValueError, match="bits"):
            mod.compress_array(np.zeros(4, np.float32), 7)


def test_snapshot_store_memory_and_disk(tmp_path):
    shape = (24, 32)
    rng = np.random.default_rng(5)
    snaps = [np.cumsum(rng.standard_normal(np.prod(shape)))
             .astype(np.float32).reshape(shape) / 30 for _ in range(6)]

    mem = C.SnapshotStore(shape, bits=12)
    for s in snaps:
        mem.append(torch.from_numpy(s))
    assert len(mem) == 6 and mem.ratio > 2.5
    for i, s in enumerate(snaps):
        r = mem.read(i)
        assert np.max(np.abs(r - s)) < 2e-3 * np.max(np.abs(s))

    path, jpath = str(tmp_path / "snaps.bin"), str(tmp_path / "snaps_jax.bin")
    disk = C.SnapshotStore(shape, bits=12, path=path)
    jdisk = J.SnapshotStore(shape, bits=12, path=jpath)
    for s in snaps:
        disk.append(s)
        jdisk.append(s)
    disk.close()
    jdisk.close()
    ro = C.SnapshotStore.open(path)
    np.testing.assert_array_equal(ro.read(3), mem.read(3))
    # each package opens the other's store and reads the same arrays
    for a, b in ((J.SnapshotStore.open(path), ro), (C.SnapshotStore.open(jpath), ro)):
        assert len(a) == len(b) == 6 and a._offsets == b._offsets
        for i in range(6):
            np.testing.assert_array_equal(a.read(i), b.read(i))
    with open(path, "rb") as f, open(jpath, "rb") as fj:
        assert f.read() == fj.read()
    with pytest.raises(ValueError, match="shape"):
        mem.append(np.zeros((2, 2), np.float32))
    with pytest.raises(IndexError):
        mem.read(6)


def test_wavefield_snapshot_fidelity():
    """Compress an actual propagated wavefield: bits=12 keeps the field to
    ~1e-3 relative max error — the imaging-grade regime. The snapshot is a
    late-time full-grid receiver row of the port's propagator, which agrees
    with the JAX package's."""
    n = 48 * 48
    kw = dict(nt=120, dt=6e-4, dx=10.0, freq=15.0, src_idx=48 * 24 + 24,
              sponge_width=6, rcv_idx=np.arange(n))
    F = wave_propagator((48, 48), dtype=torch.float32, device=CPU, **kw)
    traces = F(torch.full((48, 48), 1800.0))
    u_t = traces[90].reshape(48, 48)  # a late-time full-grid snapshot
    ref = np.asarray(j_wave_propagator((48, 48), dtype=jnp.float32, **kw)(
        jnp.full((48, 48), 1800.0, jnp.float32)))[90].reshape(48, 48)
    np.testing.assert_allclose(u_t.numpy(), ref, rtol=0,
                               atol=1e-4 * float(np.max(np.abs(ref))))
    buf = C.compress_array(u_t, 12)
    assert buf == J.compress_array(u_t.numpy(), 12)
    rec = C.decompress_array(buf, u_t.shape, 12)
    assert np.max(np.abs(rec - u_t.numpy())) < 2e-3 * float(u_t.abs().max())
    assert C.compression_ratio(u_t.numel(), 12) > 2.6


def test_tensor_input():
    """Tensors (any dtype, any layout) go to the host as float32 first; the
    JAX package takes its own arrays the same way."""
    x = jax.random.normal(jax.random.PRNGKey(0), (512,), jnp.float32)
    t = torch.from_numpy(np.array(x))
    assert C.compress_array(t, 16) == J.compress_array(x, 16)
    y = C.decompress_array(C.compress_array(t, 16), (512,), 16)
    np.testing.assert_allclose(y, np.asarray(x), atol=1e-4)
    t2 = torch.from_numpy(np.array(x, np.float64)).reshape(16, 32).t()
    assert C.compress_array(t2, 12) == J.compress_array(
        np.asarray(x, np.float64).reshape(16, 32).T, 12)
