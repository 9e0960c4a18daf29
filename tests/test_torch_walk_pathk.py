"""The LBVH walk of the path kernel's medium branch (65–8,192 triangles).

The medium branch finds each bounce's closest hit, and the pending shadow
ray's any hit, by walking the scene's LBVH (`csrc/walk.cuh`; plain version
`ops/cuda/pathk.py: _walk_isect` over `ops/bvh.py: traverse_walk_ref`).
Its contract is the sweep's: the lowest-index minimum of the
Möller–Trumbore t. These tests hold the plain walk to a per-triangle sweep
ray by ray, and the plain path kernel's rows to those of the sweep
(`pathk._isect`, which the small branch still runs), bit for bit. The only
way a walk may lose the sweep's winner is a box-rounding cull (a slab test
that rejects a box on the way to the winner's leaf); where that happens the
test asserts it as the cause.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import Bvh
from test_torch_medium import _per_triangle_sweep, _strip_obj
from test_torch_scene import LIGHTS, room_xml

EPS = np.float32(1e-4)


def _path_to_leaf(packed, leaf_node):
    """Node indices from the root down to `leaf_node` (left child n + 1,
    right child skip[n + 1]; a subtree spans [n, skip[n]))."""
    links = packed[:, 6:8].copy().view(np.int32)
    path, n = [0], 0
    while n != leaf_node:
        left = n + 1
        n = left if leaf_node < links[left, 0] else links[left, 0]
        path.append(n)
    return path


def _culled(packed, leaf, tri_id, o, d, mint, t_max) -> bool:
    """True when a slab test on the way to `tri_id`'s leaf rejects the ray
    over [mint, t_max]: the walk then never tests that triangle."""
    ids = leaf[:, 9::10].copy().view(np.int32)
    row = int(np.argwhere(ids == tri_id)[0, 0])
    first = packed[:, 7].copy().view(np.int32)
    leaf_node = int(np.flatnonzero(first == row * bvh.LEAF_SIZE)[0])
    o_, d_ = torch.tensor(o)[None], torch.tensor(d)[None]
    inv_d = bvh.safe_inv_dir(d_)
    for n in _path_to_leaf(packed, leaf_node):
        box = torch.from_numpy(packed[n])
        if not bool(bvh._slab(o_, inv_d, box[None, 0:3], box[None, 3:6],
                              torch.tensor([mint]), torch.tensor([t_max]))[0]):
            return True
    return False


def _tie_soup(rng, n_soup=300, n_pairs=32, rays_per_pair=8, n_rand=3840):
    """A random soup in [-1, 1]^3 plus `n_pairs` pairs of coplanar triangles
    in z-planes above it, on a grid that keeps pairs apart, and rays: random
    ones, and axis-aligned ones down onto a point inside both triangles of a
    pair. Every coordinate of a pair and of its rays is a multiple of 1/256
    and both triangles' det is a
    power of two, so Möller–Trumbore is exact there and both triangles give
    the same t bit for bit: exact ties between triangles whose centroids,
    and so Morton codes, differ. A pair's two ids are shuffled, so some
    walks meet the higher id first."""
    f32 = np.float32
    v0 = rng.uniform(-1, 1, (n_soup, 3))
    e1 = rng.normal(0, 0.3, (n_soup, 3))
    e2 = rng.normal(0, 0.3, (n_soup, 3))
    s = 1.0 / 32  # a pair spans ±3s around its point; the grid keeps pairs apart
    cells = rng.permutation(49)[:n_pairs]
    pair_v0, pair_e1, pair_e2, ray_o = [], [], [], []
    for cell in cells:
        x0, y0 = (cell % 7 - 3) / 4.0, (cell // 7 - 3) / 4.0
        c = 1.5 + rng.integers(0, 32) / 64.0
        tri_p = ((x0 - s, y0 - s, c), (4 * s, 0, 0), (0, 4 * s, 0))
        tri_q = ((x0 + s, y0 + s, c), (-4 * s, 0, 0), (0, -2 * s, 0))
        for a, b, e in (tri_p, tri_q)[:: 1 if rng.random() < 0.5 else -1]:
            pair_v0.append(a)
            pair_e1.append(b)
            pair_e2.append(e)
        for dx, dy in rng.integers(-4, 5, (rays_per_pair, 2)) * (s / 8):
            ray_o.append((x0 + dx, y0 + dy, 3.0))
    v0 = np.concatenate([v0, pair_v0]).astype(f32)
    e1 = np.concatenate([e1, pair_e1]).astype(f32)
    e2 = np.concatenate([e2, pair_e2]).astype(f32)
    o = np.concatenate([rng.uniform(-2, 2, (n_rand, 3)), ray_o]).astype(f32)
    d = rng.normal(size=(n_rand, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.concatenate([d, np.tile([0.0, 0.0, -1.0], (len(ray_o), 1))]).astype(f32)
    return v0, e1, e2, o, d


def test_plain_walk_equals_the_per_triangle_sweep():
    """Closest hit (id, t, u, v, attribute row) and occlusion of the medium
    branch's plain walk against a per-triangle sweep in index order, on
    4,096 rays through a 364-triangle soup with exact ties."""
    rng = np.random.default_rng(4)
    v0, e1, e2, o, d = _tie_soup(rng)
    n, t_cnt = o.shape[0], v0.shape[0]
    tri = rng.random((t_cnt, pathk.TR_COLS)).astype(np.float32)
    tri[:, 0:3], tri[:, 3:6], tri[:, 6:9] = v0, e1, e2
    packed, leaf = bvh.build_bvh_tables_from_edges(v0, e1, e2)
    so = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    sd = rng.normal(size=(n, 3))
    sd = (sd / np.linalg.norm(sd, axis=1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(rng.random(n) < 0.3, 1.5, 3.4e38).astype(np.float32)
    s_maxt = rng.uniform(0.5, 3.0, n).astype(np.float32)
    vec = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(3))
    args = (vec(o), vec(d), torch.from_numpy(mint), torch.from_numpy(maxt), vec(so), vec(sd),
            torch.from_numpy(s_maxt))
    tri_t = torch.from_numpy(tri)
    ref = _per_triangle_sweep(tri_t, t_cnt, *args)
    every = torch.ones(n, dtype=torch.bool)
    got = pathk._walk_isect(tri_t, torch.from_numpy(packed), torch.from_numpy(leaf), *args,
                            every, every)
    assert 0.2 < float(ref[3].float().mean()) < 0.8 and 0.1 < float(ref[5].float().mean()) < 0.9

    # the ties are there, and the walk meets the higher id first on some of them
    row_id = lambda row: int(torch.nonzero((tri_t == row).all(1))[0, 0])
    ids_ref = torch.tensor([row_id(r) if h else -1 for r, h in zip(ref[4], ref[3])])
    tie_rays = np.arange(3840, n)
    assert bool(ref[3][tie_rays].all())
    strict = bvh.traverse_walk_ref(torch.from_numpy(packed), torch.from_numpy(leaf),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(mint), torch.from_numpy(maxt))
    first_met = (strict[0].long() != ids_ref) & ref[3] & (strict[1] == ref[0])
    assert int(first_met[tie_rays].sum()) >= 16

    # every ray: equal, or the sweep's winner sits behind a box-rounding cull
    same = torch.ones(n, dtype=torch.bool)
    for a, b in zip(got, ref):
        eq = a == b
        same &= eq.all(dim=1) if eq.dim() == 2 else eq
    culls = 0
    for i in torch.nonzero(~same).squeeze(1).tolist():
        closest = bool(ref[3][i]) and not (bool(got[3][i])
                                           and row_id(got[4][i]) == row_id(ref[4][i]))
        occluded = bool(ref[5][i]) and not bool(got[5][i])
        assert closest or occluded, f"ray {i} differs in another way than a lost hit"
        if closest:
            assert _culled(packed, leaf, row_id(ref[4][i]), o[i], d[i], mint[i],
                           float(ref[0][i])), i
        if occluded:  # every occluder sits behind a cull
            for j in range(t_cnt):
                t, _, _, h = bvh.mt_lanes(torch.from_numpy(so[i]), torch.from_numpy(sd[i]),
                                          *(torch.from_numpy(x[j]) for x in (v0, e1, e2)))
                if bool(h) and EPS <= float(t) < s_maxt[i]:
                    assert _culled(packed, leaf, j, so[i], sd[i], EPS, float(s_maxt[i])), (i, j)
        culls += 1
    assert culls == 0, f"{culls} rays lost their hit to a box-rounding cull"


def _render_rows(scene, config, n_spp, walk: bool):
    tables, meta = pathk.build_pathk_tables(scene, config)
    if walk:
        return pathk.pathk_trace_ref(tables, meta, config, n_pix=config.width * config.height,
                                     spp0=0, n_spp=n_spp)
    sweep = lambda tri, packed, leaf, o, d, mint, maxt, so, sd, s_maxt, live, sh_pend: \
        pathk._isect(tri, meta["t_cnt"], o, d, mint, maxt, so, sd, s_maxt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pathk, "_walk_isect", sweep)
        return pathk.pathk_trace_ref(tables, meta, config, n_pix=config.width * config.height,
                                     spp0=0, n_spp=n_spp)


def _strip_room(tmp_path, w=16, h=12):
    glass = ('<shape type="sphere"><point name="center" value="0.2 0.6 0.1"/>'
             '<float name="radius" value="0.3"/><bsdf type="dielectric"/></shape>')
    xml = room_xml(tmp_path, LIGHTS["spot"], width=w, height=h,
                   extra=_strip_obj(tmp_path) + glass)
    scene, config, _ = build.load_scene(xml, device="cpu")
    return scene, dataclasses.replace(config, max_depth=3, rfilter="box")


def _tess300(integrator, w=24, h=16):
    scene, config, _ = presets.make_tessellated_cornell(w, h, 1, integrator, nu=12, nv=7,
                                                        device="cpu")
    return scene, dataclasses.replace(config, max_depth=3, rfilter="box")


@pytest.mark.parametrize("where,integrator", [("tess300", "path_mis"), ("tess300", "path_mats"),
                                              ("strip_room", "path_mis")])
def test_plain_rows_equal_the_sweep(where, integrator, tmp_path):
    """pathk_trace_ref's rows with the walk equal its rows with the sweep
    (`_isect`), bit for bit: the 300-triangle tessellated Cornell box at
    24×16, 2 spp (the scene's own LBVH), and the 70-triangle strip room
    with a glass sphere and a spot light (an LBVH built from the rows)."""
    scene, config = _tess300(integrator) if where == "tess300" else _strip_room(tmp_path)
    walk = _render_rows(scene, config, 2, walk=True)
    sweep = _render_rows(scene, config, 2, walk=False)
    assert float(walk[0:3].sum()) > 0 and bool((walk[3] == 2).all())
    torch.testing.assert_close(walk, sweep, rtol=0, atol=0)


@pytest.mark.parametrize("where", ["tess300", "strip_room", "cornell"])
def test_medium_scenes_get_walk_tables(where, tmp_path):
    """Both medium scenes carry an LBVH over all their triangles (the
    scene's own at 300 triangles; one built from the rows at 70, where the
    scene builder makes none); the small branch gets one zero row each."""
    if where == "tess300":
        scene, config = _tess300("path_mis")
    elif where == "strip_room":
        scene, config = _strip_room(tmp_path)
    else:
        scene, config, _ = presets.make_cornell_box(24, 16, 1, "path_mis", device="cpu")
    tables, meta = pathk.build_pathk_tables(scene, config)
    packed, leaf = tables["packed"], tables["leaf"]
    assert meta["n_nodes"] == packed.shape[0] and packed.shape[1] == 8 and leaf.shape[1] == 40
    if where == "cornell":
        assert meta["t_cnt"] <= pathk.VPU_MAX_TRIS and scene.geometry.bvh is None
        assert packed.shape == (1, 8) and leaf.shape == (1, 40)
        assert not packed.any() and not leaf.any()
        return
    t_cnt = meta["t_cnt"]
    n_leaves = -(-t_cnt // bvh.LEAF_SIZE)
    assert t_cnt == (300 if where == "tess300" else 70)
    assert leaf.shape[0] == n_leaves and packed.shape[0] == 2 * n_leaves - 1
    ids = leaf[:, 9::10].contiguous().view(torch.int32)
    assert torch.equal(torch.sort(ids[ids >= 0]).values, torch.arange(t_cnt, dtype=torch.int32))
    if where == "tess300":
        bits = lambda x: x.view(torch.int32)  # the links are int32 bits, some of them NaN
        assert torch.equal(bits(packed), bits(scene.geometry.bvh.packed))
        assert torch.equal(bits(leaf), bits(scene.geometry.bvh.leaf))
    else:
        assert scene.geometry.bvh is None


@pytest.mark.parametrize("where", ["tess300", "strip_room"])
def test_leaf_slots_equal_the_rows(where, tmp_path):
    """Each leaf slot's v0 | e1 | e2 is its triangle row's columns 0:9 bit
    for bit, so the walk's t, u, v are the sweep's."""
    scene, config = _tess300("path_mis") if where == "tess300" else _strip_room(tmp_path)
    tables, meta = pathk.build_pathk_tables(scene, config)
    slots = tables["leaf"].reshape(-1, bvh.LEAF_SIZE, 10)
    ids = slots[..., 9].contiguous().view(torch.int32)
    real = ids >= 0
    rows = tables["tri"][ids[real].long(), 0:9]
    assert torch.equal(slots[real][:, 0:9].view(torch.int32), rows.contiguous().view(torch.int32))


def test_walk_tables_refuse_leaves_that_differ_from_the_rows():
    """An LBVH packed from recovered corners (v1 = v0 + e1, then e1 again
    as v1 − v0) rounds e1 and e2 differently from the rows on a random
    soup; the table packing raises instead of letting the walk's t, u, v
    drift, and takes the one built from the edges themselves."""
    rng = np.random.default_rng(5)
    rows = np.zeros((300, pathk.TR_COLS), np.float32)
    rows[:, 0:9] = rng.normal(0, 1, (300, 9))
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    packed, leaf = bvh.build_bvh_tables(v0, v0 + e1, v0 + e2)
    assert not np.array_equal(e1, (v0 + e1) - v0)
    as_scene = lambda p, l: SimpleNamespace(bvh=Bvh(
        packed=torch.from_numpy(p), leaf=torch.from_numpy(l),
        pairs=torch.from_numpy(bvh.pack_child_pairs(p))))
    with pytest.raises(ValueError, match="differ from the triangle rows"):
        pathk._walk_tables(as_scene(packed, leaf), rows)
    exact = bvh.build_bvh_tables_from_edges(v0, e1, e2)
    for a, b in zip(pathk._walk_tables(as_scene(*exact), rows), exact):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    for a, b in zip(pathk._walk_tables(SimpleNamespace(bvh=None), rows), exact):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_launch_check_refuses_a_medium_scene_without_its_lbvh():
    """No fallback to a sweep: the kernel wrapper's table check raises for
    a medium scene whose walk tables are the small branch's placeholders."""
    scene, config = _tess300("path_mis")
    tables, meta = pathk.build_pathk_tables(scene, config)
    pathk._check_tables(tables, meta, torch.device("cpu"))
    tables = dict(tables, packed=torch.zeros((1, 8)), leaf=torch.zeros((1, 40)))
    with pytest.raises(ValueError, match="needs the scene's LBVH"):
        pathk._check_tables(tables, dict(meta, n_nodes=1), torch.device("cpu"))
