"""The port's pcg32 and tea are bit-exact with the JAX package and with the
integer model of ext/pcg32/pcg32.h (tests/test_rng.py). Tolerance: none —
every output word and float must be equal."""

import numpy as np
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu_torch.core import rng as trng
from test_rng import M64, PyPcg32, _split64


def _tea_model(v0, v1, n=4):
    """tea<4> from cuda/sutil/random.h:34-47 on Python ints."""
    m32 = 0xFFFFFFFF
    s0 = 0
    for _ in range(n):
        s0 = (s0 + 0x9E3779B9) & m32
        v0 = (v0 + ((((v1 << 4) & m32) + 0xA341316C) ^ ((v1 + s0) & m32)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & m32
        v1 = (v1 + ((((v0 << 4) & m32) + 0xAD90777D) ^ ((v0 + s0) & m32)
                    ^ ((v0 >> 5) + 0x7E95761E))) & m32
    return v0


def test_pcg32_matches_integer_model():
    for initstate, initseq in [(0x853C49E6748FEA9B, 0xDA3E39CB94B95BDB), (0, 0), (1, 1),
                               (12345678901234567, 987654321), (M64, M64)]:
        py = PyPcg32(initstate, initseq)
        s = trng.pcg32_seed(*_split64(initstate), *_split64(initseq))
        for _ in range(20):
            s, out = trng.pcg32_next_uint(s)
            assert int(out) == py.next_uint(), (initstate, initseq)
    py = PyPcg32()
    s = trng.pcg32_seed(*trng.PCG32_DEFAULT_STATE, *trng.PCG32_DEFAULT_STREAM)
    for _ in range(50):
        s, f = trng.pcg32_next_float(s)
        assert float(f) == py.next_float()


def test_pcg32_batched_bit_exact_vs_jax():
    r = np.random.default_rng(0)
    limbs = r.integers(0, 2**32, size=(4, 1000), dtype=np.uint64).astype(np.uint32)
    js = jrng.pcg32_seed(*(jnp.asarray(x) for x in limbs))
    ts = trng.pcg32_seed(*(torch.from_numpy(x.astype(np.int64)) for x in limbs))
    for field in range(4):
        np.testing.assert_array_equal(np.asarray(js[field]).astype(np.int64), ts[field].numpy())
    for _ in range(8):
        js, ju = jrng.pcg32_next_uint(js)
        ts, tu = trng.pcg32_next_uint(ts)
        np.testing.assert_array_equal(np.asarray(ju).astype(np.int64), tu.numpy())
        js, jf = jrng.pcg32_next_float(js)
        ts, tf = trng.pcg32_next_float(ts)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    bits = r.integers(0, 2**32, size=4096, dtype=np.uint64)
    np.testing.assert_array_equal(
        np.asarray(jrng.uint32_to_float01(jnp.asarray(bits.astype(np.uint32)))),
        trng.uint32_to_float01(torch.from_numpy(bits.astype(np.int64))).numpy())


def test_tea_bit_exact_vs_jax_and_model():
    r = np.random.default_rng(1)
    a = r.integers(0, 2**32, size=2000, dtype=np.uint64)
    b = r.integers(0, 2**32, size=2000, dtype=np.uint64)
    got = trng.tea(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    ref = jrng.tea(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    for x, y in [(0, 0), (1, 2), (123456, 789), (0xFFFFFFFF, 0xDEADBEEF)] + list(zip(a[:20], b[:20])):
        assert int(trng.tea(int(x), int(y))) == _tea_model(int(x), int(y))
