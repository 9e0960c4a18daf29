"""The port's LBVH build (`ops/bvh.py: build_bvh` / `build_sphere_bvh`, the
wrapper `ops/cuda/lbvh.py` and its kernels `csrc/lbvh.cu`) and the scene
builder's device against the JAX package, on the CPU.

* `build_bvh` / `build_sphere_bvh` with device="cpu" (the numpy builder,
  the kernel's plain version) equal the JAX `build_lbvh_numpy` and packing
  bit for bit: `packed`, `leaf`, and `pairs` from the JAX node table,
  on soups of 1 to 4,097 triangles, soups with +0 and −0 coordinates and
  repeated centroids, soups whose centroids are all equal (the 1e-12
  extent floor), and spheres;
* they equal the JAX package's C++ builder (`native/lbvh.cpp`) bit for bit
  on soups without zeros, and once zeros are normalised (x + 0.0) on soups
  with them: `std::min` keeps its first operand on a tie, numpy its second;
* the `depth` they return is `pairs_depth`, in closed form (`lbvh_depth`);
* the per-thread bodies of `csrc/lbvh.cu`, compiled by the host compiler
  and run serially (the two sorts as `std::sort`), equal the numpy builder
  bit for bit;
* the CUDA wrapper refuses CPU tensors; the loaders and presets default to
  "cuda" and raise without a GPU;
* a scene built with device="cpu" equals `scene_from_numpy` of the JAX
  build on the 300-triangle box, tensor for tensor, bit for bit;
* `host_snapshot`, how the path kernel's packing reads a card-built scene
  back in one wait, keeps every tensor bit for bit.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.native import lbvh as jnative
from optix_renderer_tpu.ops import bvh as jbvh
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops.cuda import lbvh as cuda_lbvh
from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import PhotonMap, _Tables, host_snapshot, scene_from_numpy

CSRC = Path(bvh.__file__).resolve().parents[1] / "csrc" / "lbvh.cu"
LEAF = bvh.LEAF_SIZE


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _soup(n: int, kind: str, seed: int = 0):
    """n triangles (tests/test_native_lbvh.py's soup); kind "zeros" sets 30 %
    of the coordinates to +0 and 30 % to −0 and repeats the first tenth of
    the triangles at the end; "same" gives every triangle the centroid
    (1, 2, 3), with boxes of two sizes."""
    rng = np.random.default_rng(seed + n)
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    v2 = (v0 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    if kind == "zeros":
        for v in (v0, v1, v2):
            v[rng.random((n, 3)) < 0.3] = 0.0
            v[rng.random((n, 3)) < 0.3] = -0.0
        k = max(n // 10, 1)
        for v in (v0, v1, v2):
            v[-k:] = v[:k]
    elif kind == "same":
        for v in (v0, v1, v2):
            v[:] = (1.0, 2.0, 3.0)
        v0[::2, 0], v1[::2, 0], v2[::2, 0] = 0.0, 2.0, 2.0
    return v0, v1, v2


def _spheres(n: int, seed: int = 0):
    rng = np.random.default_rng(seed + n)
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    c[rng.random((n, 3)) < 0.2] = -0.0
    c[rng.random((n, 3)) < 0.2] = 0.0
    return c, rng.uniform(0.01, 0.2, n).astype(np.float32)


def _jax_tables(v0, v1, v2):
    """The JAX package's numpy build and packing; `pairs` from its node table."""
    node_min, node_max, skip, first, prim = jbvh.build_lbvh_numpy(v0, v1, v2, LEAF)
    packed = jbvh._pack_nodes(node_min, node_max, skip, first)
    leaf = jbvh._pack_tri_leaves(prim, v0, v1 - v0, v2 - v0, LEAF)
    return packed, leaf, bvh.pack_child_pairs(packed)


def _assert_tree(tree, packed, leaf, pairs):
    for name, got, ref in (("packed", tree.packed, packed), ("leaf", tree.leaf, leaf),
                           ("pairs", tree.pairs, pairs)):
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref), err_msg=name)
    assert tree.depth == bvh.pairs_depth(pairs) == bvh.lbvh_depth(leaf.shape[0])


SOUPS = ([(n, "plain") for n in (1, 3, 4, 5, 257, 1000, 4097)]
         + [(n, "zeros") for n in (1, 5, 257, 1000, 4097)]
         + [(n, "same") for n in (4, 5, 1000)])


@pytest.mark.parametrize("n,kind", SOUPS)
def test_build_bvh_cpu_matches_jax_numpy_builder(n, kind):
    v0, v1, v2 = _soup(n, kind)
    tree = bvh.build_bvh(v0, v1, v2, "cpu")
    _assert_tree(tree, *_jax_tables(v0, v1, v2))
    assert tree.packed.device.type == "cpu"


@pytest.mark.parametrize("n", [1, 65, 1000])
def test_build_sphere_bvh_cpu_matches_jax_numpy_builder(n):
    c, r = _spheres(n)
    tree = bvh.build_sphere_bvh(c, r, "cpu")
    node_min, node_max, skip, first, prim = jbvh.build_lbvh_numpy(c - r[:, None], c + r[:, None],
                                                                  c, LEAF)
    packed = jbvh._pack_nodes(node_min, node_max, skip, first)
    _assert_tree(tree, packed, jbvh._pack_sphere_leaves(prim, c, r, LEAF),
                 bvh.pack_child_pairs(packed))


@pytest.mark.parametrize("n,kind", [(5, "plain"), (1000, "plain"), (4097, "plain"),
                                    (1000, "zeros"), (4097, "zeros")])
def test_build_bvh_matches_jax_native_builder(n, kind):
    """The C++ builder agrees bit for bit without zeros; with ±0 it differs
    only in the sign of zero box bounds (std::min against numpy's tie rule)."""
    v0, v1, v2 = _soup(n, kind)
    out = jnative.build(v0, v1, v2, LEAF)
    if out is None:
        pytest.skip("the JAX package's native builder did not load (no g++)")
    node_min, node_max, skip, first, prim = out
    packed = bvh.build_bvh(v0, v1, v2, "cpu").packed.numpy()
    links = np.ascontiguousarray(packed[:, 6:8]).view(np.int32)
    np.testing.assert_array_equal(links[:, 0], skip)
    np.testing.assert_array_equal(links[:, 1], first)
    np.testing.assert_array_equal(prim, jbvh.build_lbvh_numpy(v0, v1, v2, LEAF)[4])
    for got, ref in ((packed[:, 0:3], node_min), (packed[:, 3:6], node_max)):
        if kind == "plain":
            np.testing.assert_array_equal(_bits(got), _bits(ref))
        else:
            np.testing.assert_array_equal(_bits(got + 0.0), _bits(ref + 0.0))
            assert (got[_bits(got) != _bits(ref)] == 0.0).all()


def test_depth_closed_form_matches_pairs_depth():
    for n_leaves in [*range(1, 70), 127, 128, 129, 1000, 1025]:
        packed, _ = bvh.build_bvh_tables(*_soup(n_leaves * LEAF - 1, "plain"))
        assert packed.shape[0] == 2 * n_leaves - 1
        assert bvh.lbvh_depth(n_leaves) == bvh.pairs_depth(bvh.pack_child_pairs(packed))


_HOST_CHAIN = r"""
#include "lbvh.cu"
#include <algorithm>
#include <vector>
using namespace lbvh;
// the chain of lbvh.cu run serially: each kernel's body once per thread id,
// the sorts by std::sort, the centroid bounds by serial min / max of the keys
extern "C" int host_build(const float* v0, const float* v1, const float* v2,
                          const float* radius, long long n, int n_levels, float* packed,
                          float* leaf, float* pairs) {
  std::vector<float> cent(n * 3);
  uint32_t b[6] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0u, 0u, 0u};
  for (long long i = 0; i < n; ++i) {
    float c[3];
    centroid(v0, v1, v2, i, c);
    for (int k = 0; k < 3; ++k) {
      cent[i * 3 + k] = c[k];
      b[k] = std::min(b[k], order_key(c[k]));
      b[3 + k] = std::max(b[3 + k], order_key(c[k]));
    }
  }
  std::vector<long long> keys(n);
  for (long long i = 0; i < n; ++i) keys[i] = morton_key(cent.data(), b, i);
  std::sort(keys.begin(), keys.end());
  const int n_leaves = (int)((n + LEAF - 1) / LEAF), n_nodes = 2 * n_leaves - 1;
  std::vector<long long> pkey(n_nodes);
  const Tree t{v0, v1, v2, radius, n, n_leaves, keys.data(), packed, leaf, pkey.data()};
  for (int l = 0; l < n_leaves; ++l) leaf_body(t, l, leaf + (long long)l * leaf_cols(t));
  for (int lev = n_levels - 2; lev >= 0; --lev)
    for (int i = 0; i < n_nodes; ++i) box_body(packed, pkey.data(), i, lev);
  if (n_leaves == 1) {
    root_leaf_row(packed, pairs);
    return 0;
  }
  std::sort(pkey.begin(), pkey.end());
  std::vector<int> row_of(n_nodes, -1);
  for (int r = 0; r < n_leaves - 1; ++r) row_of[pkey[r] & 0xffffffffLL] = r;
  for (int r = 0; r < n_leaves - 1; ++r)
    pair_body(packed, row_of.data(), (int)(pkey[r] & 0xffffffffLL), pairs + r * 16);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_chain(tmp_path_factory):
    """csrc/lbvh.cu's bodies built by g++ into a shared library, or a skip."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("lbvh_host")
    (d / "chain.cpp").write_text(_HOST_CHAIN)
    so = d / "libchain.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(CSRC.parent), "-o", str(so), str(d / "chain.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.host_build.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, p]

    def run(v0, v1, v2, radius=None):
        n = v0.shape[0]
        n_leaves = -(-n // LEAF)
        arrays = [np.ascontiguousarray(x, np.float32) for x in (v0, v1, v2)]
        radius = None if radius is None else np.ascontiguousarray(radius, np.float32)
        packed = np.full((2 * n_leaves - 1, 8), 7.0, np.float32)
        leaf = np.full((n_leaves, LEAF * (10 if radius is None else 5)), 7.0, np.float32)
        pairs = np.full((max(n_leaves - 1, 1), 16), 7.0, np.float32)
        lib.host_build(*(x.ctypes.data for x in arrays),
                       None if radius is None else radius.ctypes.data, n,
                       bvh.lbvh_levels(n_leaves), packed.ctypes.data, leaf.ctypes.data,
                       pairs.ctypes.data)
        return packed, leaf, pairs

    return run


@pytest.mark.parametrize("n,kind", [(1, "plain"), (3, "zeros"), (5, "zeros"), (257, "plain"),
                                    (4097, "zeros"), (20_000, "zeros"), (1000, "same")])
def test_kernel_bodies_match_numpy_builder(host_chain, n, kind):
    v0, v1, v2 = _soup(n, kind)
    tree = bvh.build_bvh(v0, v1, v2, "cpu")
    for name, got, ref in zip(("packed", "leaf", "pairs"), host_chain(v0, v1, v2),
                              (tree.packed, tree.leaf, tree.pairs)):
        np.testing.assert_array_equal(_bits(got), _bits(ref.numpy()), err_msg=name)


@pytest.mark.parametrize("n", [1, 65, 10_000])
def test_kernel_bodies_match_numpy_sphere_builder(host_chain, n):
    c, r = _spheres(n)
    tree = bvh.build_sphere_bvh(c, r, "cpu")
    got = host_chain(c - r[:, None], c + r[:, None], c, r)
    for name, g, ref in zip(("packed", "leaf", "pairs"), got, (tree.packed, tree.leaf, tree.pairs)):
        np.testing.assert_array_equal(_bits(g), _bits(ref.numpy()), err_msg=name)


def test_cuda_wrapper_refuses_cpu_tensors():
    v = torch.zeros((8, 3))
    before = dict(cuda_lbvh.LAUNCHES)
    with pytest.raises(ValueError, match="cuda tensors"):
        cuda_lbvh.lbvh_build(v, v, v)
    with pytest.raises(ValueError, match="cuda tensors"):
        cuda_lbvh.lbvh_build(v, v, v, torch.ones(8))
    assert cuda_lbvh.LAUNCHES == before


def test_loaders_default_to_cuda_and_raise_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xml = presets.cornell_box_xml(tmp_path, 8, 6, 1, "path_mis")
    with pytest.raises(RuntimeError, match="cuda"):
        build.load_scene(xml)
    with pytest.raises(RuntimeError, match="cuda"):
        build.load_scene(xml, device="cuda")
    for make in (presets.make_cornell_box, presets.make_tessellated_cornell,
                 presets.make_absorbing_sphere):
        with pytest.raises(RuntimeError, match="cuda"):
            make(width=8, height=6, spp=1)
    scene, _, _ = build.load_scene(xml, device="cpu")
    assert scene.geometry.tri_v0.device.type == "cpu"


def _tensors(x, path=""):
    """(path, tensor) of every tensor of a scene, depth first."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, _Tables):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, PhotonMap):
        for k in x._fields:
            yield from _tensors(getattr(x, k), f"{path}.{k}")


def test_cpu_scene_matches_jax_build_on_the_300_triangle_box():
    js, jc, _ = jpresets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7)
    ref = dict(_tensors(scene_from_numpy(jax.tree.map(np.asarray, js))))
    ts, tc, _ = presets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7, device="cpu")
    got = dict(_tensors(ts))
    assert ts.geometry.bvh is not None and tc.n_tris == 300
    assert got.keys() == ref.keys() and len(got) > 80
    # the JAX build takes its C++ builder where g++ is present: box bounds
    # are compared after x + 0.0 (the sign of a zero bound may differ)
    boxes = {".geometry.bvh.packed": slice(0, 6), ".geometry.bvh.pairs": slice(0, 12)}
    for path, t in got.items():
        r = ref[path]
        assert t.device.type == "cpu" and t.dtype == r.dtype and t.shape == r.shape, path
        if path in boxes:
            t, r = t.clone(), r.clone()
            t[:, boxes[path]] += 0.0
            r[:, boxes[path]] += 0.0
        if t.is_floating_point():
            words = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
            t, r = t.view(words), r.view(words)
        assert torch.equal(t, r), path


def test_host_snapshot_keeps_every_tensor():
    """`host_snapshot`, the one read of a scene that the path kernel's
    packing makes of a card-built scene, returns every tensor (nested
    tables, the photon map, tuples and dicts of them) bit for bit,
    detached, on the host, and the same tables to pack."""
    scene, cfg, _ = presets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7, device="cpu")
    scene = dataclasses.replace(scene, bsdfs=scene.bsdfs._map(
        lambda t: t.requires_grad_(t.is_floating_point())))
    want, got = dict(_tensors(scene)), dict(_tensors(host_snapshot(scene)))
    assert got.keys() == want.keys() and len(got) > 80
    for path, t in want.items():
        assert got[path].device.type == "cpu" and not got[path].requires_grad, path
        np.testing.assert_array_equal(_words(got[path]), _words(t), err_msg=path)
    mixed = host_snapshot({"a": (scene.shapes.bsdf, [scene.camera.fov]), "b": 3})
    assert torch.equal(mixed["a"][0], scene.shapes.bsdf) and mixed["b"] == 3
    assert torch.equal(mixed["a"][1][0], scene.camera.fov)
    tables, meta = pathk.build_pathk_tables(scene, cfg)
    snap_tables, snap_meta = pathk.build_pathk_tables(host_snapshot(scene), cfg)
    assert snap_meta == meta
    for name, t in tables.items():
        np.testing.assert_array_equal(_words(snap_tables[name]), _words(t), err_msg=name)


def _words(t) -> np.ndarray:
    """A tensor's words as unsigned integers (NaN-boxed links compare)."""
    a = t.detach().numpy()
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize]) \
        if a.dtype.kind == "f" else a
