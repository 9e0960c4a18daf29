"""The scan path's sample round, captured once as a CUDA graph and replayed.

A round of `render.scan_step` issues ~20,000 small kernels a sample (camera
rays, the bounce loop with its `isect_*` launches, the splat), and the host
paces it. On a CUDA device, for an integrator in `GRAPH_INTEGRATORS` and a
scene none of whose tensors requires grad (`graphable`), `graph_step` renders
the round through the same code, captured once into a `torch.cuda.CUDAGraph`
and replayed for every later sample: one graph launch a sample. Every other
round runs that code eagerly (`eager_step`). `shade_scene` is the one rule
for the rounds whose bounces take the shading kernel of `csrc/scan.cu`.

What a replay bakes in, and how it is fed:

- the scene's tensors by address: the cache entry holds them, so an edit of
  one in place is read by the next replay; its key (`cache_key`) holds each
  tensor's address, shape, dtype, strides and version, and every field of
  the config but the seed and the sample count, and the device;
- the seed and the sample index, the only values that change between renders
  of one scene, reach the round as one int64 device scalar, `(sample & M32)
  ^ (seed & M32)`, which `render/sampler.py: make_sampler` takes as its
  sample index with seed 0 (`tea(pixel, sample ^ seed)`: the same bits);
- the film: the graph splats into one of its own, into which each step
  copies the caller's accumulator and from which it copies it back;
- the camera's sample-to-camera matrix, inverted on the host at the capture
  as the eager round inverts it every round (`ops/camera.py: sample_ray`).

The round before a capture runs eagerly: it renders its sample and loads
every kernel the capture then records. A capture that fails raises.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import torch

from optix_renderer_tpu_torch.core.rng import M32
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.ops.cuda import mega
from optix_renderer_tpu_torch.ops.cuda import scan as scan_shade
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing

# integrators whose replayed rounds a card test holds bit for bit against
# eager (tests/test_torch_scan_graph.py), and whose bounces may take the
# shading kernel (`shade_scene`); each other one runs eagerly
GRAPH_INTEGRATORS = frozenset({"path_mis", "path_mats"})
CACHE_SIZE = 4  # captured rounds kept, least recently used first out

_cache: collections.OrderedDict = collections.OrderedDict()  # cache_key -> _Round
_lock = threading.Lock()  # one step at a time: the entries' films and scalars are shared


def _tensors(x):
    """Every tensor of a scene's table tree."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _scene_key(x):
    if isinstance(x, torch.Tensor):
        return (x.data_ptr(), tuple(x.shape), x.dtype, x.stride(), x._version)
    if dataclasses.is_dataclass(x):
        return tuple(_scene_key(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_scene_key(v) for v in x)
    return x


def cache_key(scene: SceneData, config: RenderConfig, device) -> tuple:
    """What a captured round bakes in: the scene's tensors as placed on the
    device and its other fields, the config but its seed and sample count,
    and the device."""
    return (_scene_key(scene), dataclasses.replace(config, seed=0, sample_count=0),
            torch.device(device))


def graphable(scene: SceneData, config: RenderConfig, device) -> bool:
    """Whether `scan_step` replays its rounds as a CUDA graph."""
    return (torch.device(device).type == "cuda" and config.integrator in GRAPH_INTEGRATORS
            and not any(t.requires_grad for t in _tensors(scene)))


def shade_scene(scene: SceneData, config: RenderConfig, device) -> scan_shade.ShadeScene | None:
    """The shading kernel's tables for the scan rounds of (scene, config) on
    `device`, or None where they run the torch chain: the kernel takes what
    `graphable` passes and `ops/cuda/mega.py: surface_unsupported` finds no
    fault in. That test waits on a `host_snapshot`, so each render asks once,
    before any capture, and passes the answer down."""
    if not graphable(scene, config, device):
        return None  # no table read: the CPU's rounds, other integrators, gradients
    if mega.surface_unsupported(scene, config):
        return None
    return scan_shade.ShadeScene(scene, config)


def sample_scalar(sample: int, seed: int) -> int:
    """The value of the round's sample scalar: `make_sampler(pixels, it,
    seed=0)` draws what `make_sampler(pixels, sample, seed=seed)` does."""
    return (sample & M32) ^ (seed & M32)


def count_round(graphed: bool, fused: bool) -> None:
    """Count one sample round of `scan_step` in a traced request: in
    `scan.rounds`, in `scan.rounds_graphed` if it was replayed, and in
    `scan.rounds_fused` 1 if it took the shading kernel, else 0."""
    if tracing.recording():
        tracing.count("scan.rounds")
        if graphed:
            tracing.count("scan.rounds_graphed")
        tracing.count("scan.rounds_fused", int(fused))


@dataclasses.dataclass
class _Round:
    """One captured sample round and the buffers its graph reads and writes."""

    graph: torch.cuda.CUDAGraph
    counted: tracing.Capture  # its launches and its live-lane buffers
    film: torch.Tensor  # [3,H,W,4]
    sample: torch.Tensor  # int64 [], sample_scalar()
    keep: tuple  # the scene, pixel ids and matrix whose addresses the graph holds
    sc: scan_shade.ShadeScene | None  # the rule's answer: its bounces take csrc/scan.cu

    def run(self, acc: torch.Tensor, spp0: int, n: int, seed: int) -> None:
        """Samples spp0 … spp0 + n − 1 into `acc`."""
        if n <= 0:
            return
        self.film.copy_(acc)
        for s in range(spp0, spp0 + n):
            with tracing.span("scan.round"):
                self.sample.fill_(sample_scalar(s, seed))
                self.graph.replay()
                tracing.replayed(self.counted)
                count_round(graphed=True, fused=self.sc is not None)
        acc.copy_(self.film)


def _capture(scene: SceneData, config: RenderConfig, ids: torch.Tensor, rounds,
             acc: torch.Tensor, sc) -> _Round:
    s2c = camera_ops.sample_to_camera_matrix(scene.camera.to("cpu"), config.width,
                                             config.height).to(ids.device)
    film = torch.zeros_like(acc)
    sample = torch.zeros((), dtype=torch.int64, device=ids.device)
    graph = torch.cuda.CUDAGraph()
    counted = tracing.Capture()
    # "thread_local": CUDA calls of another thread do not invalidate the capture
    with tracing.capturing(counted), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        rounds(film, sample, dataclasses.replace(config, seed=0), sc, s2c)
    tracing.count("scan.graph_captures")
    return _Round(graph, counted, film, sample, keep=(scene, ids, s2c), sc=sc)


def eager_step(scene: SceneData, config: RenderConfig, ids: torch.Tensor, rounds):
    """`step(acc, spp0, n)` of `scan_step` for a round that is not
    `graphable`: `rounds(acc, sample, config, sc, None)` for each sample in
    turn, `sc` the rule's answer, asked once."""
    sc = shade_scene(scene, config, ids.device)

    def step(acc: torch.Tensor, spp0: int, n: int) -> None:
        for s in range(spp0, spp0 + n):
            count_round(graphed=False, fused=sc is not None)
            rounds(acc, s, config, sc, None)

    return step


def graph_step(scene: SceneData, config: RenderConfig, ids: torch.Tensor, rounds):
    """`step(acc, spp0, n)` of `scan_step` for a `graphable` round:
    `rounds(acc, sample, config, sc, s2c)` renders one sample round into
    `acc` (eagerly, or captured when `sample` is the device scalar). On a
    miss the rule gives `sc`, which the captured entry keeps."""

    def step(acc: torch.Tensor, spp0: int, n: int) -> None:
        key = cache_key(scene, config, ids.device)
        with _lock, torch.cuda.device(ids.device):
            entry = _cache.get(key)
            if entry is None:
                sc = shade_scene(scene, config, ids.device)
                count_round(graphed=False, fused=sc is not None)
                rounds(acc, spp0, config, sc, None)
                spp0, n = spp0 + 1, n - 1
                entry = _cache[key] = _capture(scene, config, ids, rounds, acc, sc)
                while len(_cache) > CACHE_SIZE:
                    _cache.popitem(last=False)
            _cache.move_to_end(key)
            entry.run(acc, spp0, n, config.seed)

    return step
