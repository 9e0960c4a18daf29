"""The brute-force sweep `isect_brute` (csrc/isect.cu: brute_kernel) on the
CPU, where it runs its plain version `mt_sweep_ref`, against the JAX
package on the same inputs made from a numpy seed.

* at the kernel's three measured sizes, T = 12 (the Cornell box), 64 (a
  soup) and 252 (the tessellated Cornell box at nu=10, nv=7): ids equal to
  `_mt_jnp`'s, t within 1e-6 relative (XLA on the CPU contracts
  multiply-adds into FMAs and torch does not, so t agrees to rounding);
* exact ties: a triangle and its duplicate, in either order and on either
  side of a chunk boundary of the plain sweep, resolve to the lower index,
  as the kernel's ascending sweep with strict < does;
* the scan path hands the sweep the scene's one `Geometry.tri_table`: the
  kernel pads rows while it stages them, so no host table is built per
  call;
* the wrapper's refusals, on either device: wrong dtype, wrong shape, zero
  triangles, mismatched rays, and devices other than cpu and cuda (never
  the plain version there);
* the bound that chip_smoke.py and tools/time_isect.py print beside the
  kernel's time, and their count of instructions per ray-triangle pair in
  a SASS listing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.pallas.mt_kernel import _mt_jnp
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.ops import intersect as intersect_mod
from optix_renderer_tpu_torch.ops.camera import sample_ray
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.tools.time_isect import brute_bound, sweep_loops
from optix_renderer_tpu_torch.utils import tracing


def _f32(x):
    return np.asarray(x, np.float32)


def _camera_case(rng, t_cnt, n=2048):
    """The scene's triangle table and n camera rays through random film
    positions of a 32x24 film."""
    if t_cnt == 12:
        scene, _, _ = presets.make_cornell_box(32, 24, 1, device="cpu")
    else:
        scene, _, _ = presets.make_tessellated_cornell(32, 24, 1, nu=10, nv=7, device="cpu")
    pos = _f32(rng.uniform((0, 0), (32, 24), (n, 2)))
    ray, _ = sample_ray(scene.camera, 32, 24, torch.from_numpy(pos),
                        torch.from_numpy(_f32(rng.uniform(size=(n, 2)))))
    return (scene.geometry.tri_table.numpy(),
            *(x.numpy() for x in (ray.o, ray.d, ray.mint, ray.maxt)))


def _soup_case(rng, t_cnt=64, n=2048):
    """A soup of t_cnt triangles and n rays aimed at it."""
    tri = _f32(np.concatenate([rng.uniform(-1, 1, (t_cnt, 3)),
                               rng.normal(0, 0.2, (t_cnt, 6))], axis=1))
    o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, _f32(o), _f32(d), _f32(np.full(n, 1e-4)), _f32(np.full(n, 3.4e38))


@pytest.mark.parametrize("t_cnt", [12, 64, 252])
def test_isect_brute_matches_mt_jnp(t_cnt):
    rng = np.random.default_rng(11 + t_cnt)
    tri, o, d, mint, cut = _soup_case(rng) if t_cnt == 64 else _camera_case(rng, t_cnt)
    assert tri.shape == (t_cnt, 9)
    j_t, _, _, j_idf = jax.jit(_mt_jnp)(*map(jnp.asarray, (o, d, mint, cut, tri[:, 0:3],
                                                         tri[:, 3:6], tri[:, 6:9])))
    T = torch.from_numpy
    before = tracing.counters("launch.")
    ids, t, _, _ = isect.isect_brute(T(tri), *map(T, (o, d, mint, cut)))
    assert tracing.counters("launch.") == before
    j_id = np.asarray(j_idf).astype(np.int32)
    assert 0.2 < (j_id >= 0).mean()
    np.testing.assert_array_equal(ids.numpy(), j_id)
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), rtol=1e-6)


@pytest.mark.parametrize("split", [False, True])
def test_exact_ties_go_to_the_lower_index(monkeypatch, split):
    """Triangle 5 of a 64-triangle soup duplicated at index 40, then the
    table reversed: every ray that hits it takes the lower of its two
    indices. With `split`, the plain sweep steps 8 triangles at a time, so
    the two copies lie in different chunks."""
    rng = np.random.default_rng(5)
    tri, o, _, mint, cut = _soup_case(rng, 64, 1024)
    tri[40] = tri[5]
    # rays aimed at the duplicated triangle's centroid
    c = tri[5, 0:3] + (tri[5, 3:6] + tri[5, 6:9]) / 3.0
    d = c[None, :] - o
    d = _f32(d / np.linalg.norm(d, axis=1, keepdims=True))
    if split:
        monkeypatch.setattr(isect, "_SWEEP_PAIRS", 8 * o.shape[0])
        assert isect._sweep_chunk(o.shape[0], 64) == 8
    T = torch.from_numpy
    for table, pair in ((tri, (5, 40)), (np.ascontiguousarray(tri[::-1]), (23, 58))):
        ids, t, _, _ = isect.isect_brute(T(table), *map(T, (o, d, mint, cut)))
        ids = ids.numpy()
        on_dup = np.isin(ids, pair)
        assert on_dup.mean() > 0.5
        assert (ids[on_dup] == min(pair)).all()
        # the JAX sweep's argmin takes the first of equal t as well
        _, _, _, j_idf = jax.jit(_mt_jnp)(*map(jnp.asarray, (o, d, mint, cut, table[:, 0:3],
                                                             table[:, 3:6], table[:, 6:9])))
        np.testing.assert_array_equal(ids, np.asarray(j_idf).astype(np.int32))


def test_scan_path_passes_the_geometry_table(monkeypatch):
    """intersect() hands isect_brute the Geometry's own [T, 9] table on
    every call, detached (a view of the same storage, so no copy): the
    kernel pads its rows in shared memory, so there is no per-call host
    table to build."""
    scene, _, _ = presets.make_cornell_box(8, 6, 1, device="cpu")
    geom = scene.geometry
    seen = []
    real = isect.isect_brute

    def spy(tri, *rays):
        seen.append(tri)
        return real(tri, *rays)

    monkeypatch.setattr(isect, "isect_brute", spy)
    rng = np.random.default_rng(2)
    for _ in range(2):
        o = torch.from_numpy(_f32(rng.uniform(-0.5, 0.5, (64, 3)) + [0.0, 1.0, 0.0]))
        d = torch.nn.functional.normalize(torch.from_numpy(_f32(rng.normal(size=(64, 3)))), dim=-1)
        hit = intersect_mod.intersect(geom, Ray(o=o, d=d, mint=torch.full((64,), 1e-4),
                                                maxt=torch.full((64,), float("inf"))))
        # the box is open toward the camera, so some rays leave it
        assert float((hit.t < 1e30).float().mean()) > 0.5
    own = geom.tri_table
    assert len(seen) == 2 and all(
        x.data_ptr() == own.data_ptr() and x.shape == own.shape and x.stride() == own.stride()
        and not x.requires_grad for x in seen)
    assert geom.tri_table.shape == (12, 9) and geom.tri_table.is_contiguous()


def _ok_inputs(n=16, t_cnt=12):
    rng = np.random.default_rng(0)
    tri, o, d, mint, cut = _soup_case(rng, t_cnt, n)
    return [torch.from_numpy(x) for x in (tri, o, d, mint, cut)]


@pytest.mark.parametrize("case", ["tri_float64", "tri_8_cols", "tri_flat", "no_triangles",
                                  "tri_strided", "o_float64", "mint_shape", "cutoff_2d",
                                  "meta_device"])
def test_isect_brute_refusals(case):
    tri, o, d, mint, cut = _ok_inputs()
    if case == "tri_float64":
        tri = tri.double()
    elif case == "tri_8_cols":
        tri = tri[:, :8].contiguous()
    elif case == "tri_flat":
        tri = tri.reshape(-1)
    elif case == "no_triangles":
        tri = tri[:0]
    elif case == "tri_strided":
        tri = torch.cat([tri, tri], dim=1)[:, :9]
    elif case == "o_float64":
        o = o.double()
    elif case == "mint_shape":
        mint = mint[:-1]
    elif case == "cutoff_2d":
        cut = cut[:, None]
    elif case == "meta_device":
        tri, o, d, mint, cut = (x.to("meta") for x in (tri, o, d, mint, cut))
    before = tracing.counters("launch.")
    with pytest.raises(ValueError):
        isect.isect_brute(tri, o, d, mint, cut)
    assert tracing.counters("launch.") == before
    # the same inputs, corrected, run the plain version
    ids, t, u, v = isect.isect_brute(*_ok_inputs())
    assert ids.dtype == torch.int32 and t.shape == u.shape == v.shape == (16,)


def test_brute_bound():
    """T = 12 is bound by bytes (48 B per ray over 3.35 TB/s); T = 252 by
    operations (52 per pair over 67 TFLOP/s), twice that without FMA."""
    b12, b252 = brute_bound(480_000, 12), brute_bound(480_000, 252)
    assert b12["bound_by"] == "bytes" and b12["bound_ms"] == pytest.approx(0.006878, rel=1e-3)
    # without FMA the 12 tests per ray take longer than the bytes
    assert b12["fmad_free_ms"] == pytest.approx(0.009070, rel=1e-3)
    assert b252["bound_by"] == "operations"
    assert b252["bound_ms"] == pytest.approx(0.093944, rel=1e-3)
    assert b252["fmad_free_ms"] == pytest.approx(2 * b252["bound_ms"], rel=1e-9)


# a cuobjdump -sass listing in miniature: a staging loop (no division), and
# a sweep loop of two divisions whose slow path (a CALL that a forward
# branch jumps over) is left out of the fast path
_SASS = """
        Function : _ZN5isect12brute_kernelILb1EEEvPKf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   STS [R1], R0 ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   LDS.128 R4, [R2] ;
        /*0040*/                   FMUL R8, R4, R5 ;
        /*0050*/                   MUFU.RCP R9, R8 ;
        /*0060*/                   MUFU.RCP R10, R8 ;
        /*0070*/                   VOTE.ANY P4, P4 ;
        /*0080*/              @!P4 BRA 0xc0 ;
        /*0090*/                   MOV R12, 0xb0 ;
        /*00a0*/                   CALL.REL.NOINC 0x200 ;
        /*00b0*/                   BRA 0xc0 ;
        /*00c0*/                   FSETP.GE.AND P0, PT, R9, RZ, PT ;
        /*00d0*/               @P0 BRA 0x30 ;
        /*00e0*/                   EXIT ;
        Function : _ZN2pk12pathk_kernelILb1EEEvv
        /*0000*/                   MUFU.RCP R0, R1 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_sweep_loops_counts_the_fast_path():
    loops = sweep_loops(_SASS)
    assert list(loops) == ["_ZN5isect12brute_kernelILb1EEEvPKf"]
    (loop,) = loops["_ZN5isect12brute_kernelILb1EEEvPKf"]
    # 0x30-0xd0 is 11 instructions; MOV, CALL and BRA of the slow path are out
    assert (loop["start"], loop["end"], loop["fast_path"], loop["mufu"]) == ("0x30", "0xd0", 8, 2)
    assert loop["per_pair"] == 4.0
    assert loop["opcodes"]["MUFU"] == 2 and "CALL" not in loop["opcodes"]
