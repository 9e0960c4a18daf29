"""pcg32, tea and the LCG on torch tensors, bit-exact with `optix_renderer_tpu/core/rng.py`.

Every 32-bit word is carried in an int64 tensor holding a value in
[0, 2^32): torch's uint32 arithmetic is incomplete on the CPU, and int64
never overflows in the products below because one operand is always split
into 16-bit limbs. The 64-bit pcg32 state is two such words (hi, lo), as in
the JAX module. The CUDA kernel (csrc/mega.cuh) uses native uint32/uint64
arithmetic for the same streams.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

M32 = 0xFFFFFFFF

PCG32_DEFAULT_STATE = (0x853C49E6, 0x748FEA9B)  # 0x853c49e6748fea9bULL
PCG32_DEFAULT_STREAM = (0xDA3E39CB, 0x94B95BDB)  # 0xda3e39cb94b95bdbULL
PCG32_MULT = (0x5851F42D, 0x4C957F2D)  # 0x5851f42d4c957f2dULL


def u32(x, device=None) -> torch.Tensor:
    """Python int / array / tensor → int64 tensor of 32-bit words."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def _mul_lo32(a, b):
    """(a * b) mod 2^32 for 32-bit words a, b (b split in 16-bit limbs)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mul32_wide(a, b):
    """Full 32x32→64 multiply via 16-bit limbs. Returns (hi, lo) words."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    t = a0 * b0
    u = a1 * b0 + (t >> 16)
    v = a0 * b1 + (u & 0xFFFF)
    hi = (a1 * b1 + (u >> 16) + (v >> 16)) & M32
    lo = ((v << 16) | (t & 0xFFFF)) & M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = (al + bl) & M32
    carry = (lo < al).to(torch.int64)
    hi = (ah + bh + carry) & M32
    return hi, lo


def _mul64_lo(ah, al, bh, bl):
    """Low 64 bits of a 64x64 multiply; operands/result as (hi, lo) words."""
    hi, lo = _mul32_wide(al, bl)
    hi = (hi + _mul_lo32(al, bh) + _mul_lo32(ah, bl)) & M32
    return hi, lo


class Pcg32State(NamedTuple):
    """Batched pcg32: every field an int64 tensor of 32-bit words."""

    state_hi: torch.Tensor
    state_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor


def _pcg32_step(s: Pcg32State) -> Pcg32State:
    hi, lo = _mul64_lo(s.state_hi, s.state_lo, PCG32_MULT[0], PCG32_MULT[1])
    hi, lo = _add64(hi, lo, s.inc_hi, s.inc_lo)
    return Pcg32State(hi, lo, s.inc_hi, s.inc_lo)


def _pcg32_output(state_hi, state_lo):
    """XSH-RR output function on the pre-step state (pcg32.h nextUInt)."""
    x_hi = state_hi ^ (state_hi >> 18)
    x_lo = state_lo ^ (((state_hi << 14) & M32) | (state_lo >> 18))
    xorshifted = ((x_hi << 5) & M32) | (x_lo >> 27)
    rot = state_hi >> 27  # state >> 59
    nrot = (-rot) & 31
    return ((xorshifted >> rot) | (xorshifted << nrot)) & M32


def pcg32_seed(initstate_hi, initstate_lo, initseq_hi, initseq_lo) -> Pcg32State:
    """pcg32::seed (pcg32.h): state=0; inc=(seq<<1)|1; step; state+=init; step."""
    ish, isl = u32(initstate_hi), u32(initstate_lo)
    qh, ql = u32(initseq_hi), u32(initseq_lo)
    inc_hi = ((qh << 1) & M32) | (ql >> 31)
    inc_lo = ((ql << 1) & M32) | 1
    s = Pcg32State(torch.zeros_like(inc_hi), torch.zeros_like(inc_lo), inc_hi, inc_lo)
    s = _pcg32_step(s)
    hi, lo = _add64(s.state_hi, s.state_lo, ish, isl)
    return _pcg32_step(Pcg32State(hi, lo, s.inc_hi, s.inc_lo))


def pcg32_next_uint(s: Pcg32State) -> tuple[Pcg32State, torch.Tensor]:
    """Advance and emit 32 random bits (pcg32.h nextUInt: output(old), step)."""
    out = _pcg32_output(s.state_hi, s.state_lo)
    return _pcg32_step(s), out


def pcg32_advance(s: Pcg32State, delta: int) -> Pcg32State:
    """The state after `delta` steps, by jump-ahead in O(log delta) steps
    (pcg32.h advance(), Brown's "random number generation with arbitrary
    strides"): the multiplier's powers are Python integers mod 2^64, the
    increment's sums tensors of (hi, lo) words, as in `_pcg32_step`."""
    mask64 = (1 << 64) - 1
    cur_mult = (PCG32_MULT[0] << 32) | PCG32_MULT[1]
    cur_hi, cur_lo = s.inc_hi, s.inc_lo  # cur_plus
    acc_mult = 1
    acc_hi, acc_lo = torch.zeros_like(s.inc_hi), torch.zeros_like(s.inc_lo)  # acc_plus
    delta = int(delta) & mask64
    while delta:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & mask64
            acc_hi, acc_lo = _mul64_lo(acc_hi, acc_lo, cur_mult >> 32, cur_mult & M32)
            acc_hi, acc_lo = _add64(acc_hi, acc_lo, cur_hi, cur_lo)
        m1 = (cur_mult + 1) & mask64
        cur_hi, cur_lo = _mul64_lo(cur_hi, cur_lo, m1 >> 32, m1 & M32)
        cur_mult = (cur_mult * cur_mult) & mask64
        delta >>= 1
    hi, lo = _mul64_lo(s.state_hi, s.state_lo, acc_mult >> 32, acc_mult & M32)
    hi, lo = _add64(hi, lo, acc_hi, acc_lo)
    return Pcg32State(hi, lo, s.inc_hi, s.inc_lo)


def uint32_to_float01(bits: torch.Tensor) -> torch.Tensor:
    """[0,1) float32 from 32 bits, exactly pcg32::nextFloat's bit trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def pcg32_next_float(s: Pcg32State) -> tuple[Pcg32State, torch.Tensor]:
    s, bits = pcg32_next_uint(s)
    return s, uint32_to_float01(bits)


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA hash, matches `tea<N>(val0, val1)` (cuda/sutil/random.h:34-47)."""
    v0 = u32(val0)
    v1 = u32(val1, device=v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) & M32) + 0xA341316C)
                    ^ ((v1 + s0) & M32) ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) & M32) + 0xAD90777D)
                    ^ ((v0 + s0) & M32) ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0


def lcg_step(state) -> torch.Tensor:
    """LCG of cuda/sutil/random.h:50-56: state·1664525 + 1013904223 mod 2^32
    (the product stays below 2^53, so int64 holds it exactly)."""
    return (u32(state) * 1664525 + 1013904223) & M32


def lcg_next_float(state) -> tuple[torch.Tensor, torch.Tensor]:
    """`rnd(seed)` (cuda/sutil/random.h:64-67): the stepped state and its low
    24 bits / 2^24 as float32, exactly."""
    state = lcg_step(state)
    return state, (state & 0x00FFFFFF).to(torch.float32) / float(1 << 24)
