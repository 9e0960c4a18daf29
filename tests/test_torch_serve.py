"""The port's live view (`serve.py`, `render --serve`) on the CPU.

* `_EDITS` applied through `LiveRenderer.edit` / `_apply_edits` give the
  same tables in both packages, and the same requests are refused; `edit`
  checks a request against the host-side shapes without reading the scene;
* one live loop over loopback HTTP at 16×12, depth 2: frames progress,
  pause holds the count, an edit bumps `generation` and restarts the count,
  a bad edit is answered 400, and stop returns the layers;
* `render --serve` through `cli.main`: stopped over HTTP, it writes the EXR
  and PNG and returns 0;
* under a short switch interval, edits POSTed from one thread per row
  while more threads than cores read the status and frame all reach the
  tables: each row ends at its thread's last value.
"""

import dataclasses
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.scene.presets import make_cornell_box as jmake_cornell_box
from optix_renderer_tpu.serve import LiveRenderer as JLiveRenderer
from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml, make_cornell_box
from optix_renderer_tpu_torch.serve import (
    _EDITS,
    LiveRenderer,
    ThreadingHTTPServer,
    _make_handler,
)
from optix_renderer_tpu_torch.utils.imageio import read_exr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait(port, cond, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = json.loads(_get(port, "/status"))
        if cond(st):
            return st
        time.sleep(0.05)
    raise AssertionError(f"timed out at {st}")


EDITS = [("emitter_radiance", 0, [5.0, 6.0, 7.0]), ("bsdf_kd", 1, [0.2, 0.3, 0.4]),
         ("bsdf_alpha", 0, [0.42]), ("texture_value", 2, [0.9]),
         ("emitter_radiance", 0, [2.5])]
REFUSED = [("emitter_radiance", 999, [1, 1, 1]), ("emitter_radiance", 0, [1.0, 2.0]),
           ("nope", 0, [1.0]), ("bsdf_kd", -1, [1, 1, 1]), ("bsdf_alpha", 0, ["x"])]


def test_edits_match_jax():
    scene, config, _ = make_cornell_box(width=8, height=6, spp=1, device="cpu")
    jscene, jconfig, _ = jmake_cornell_box(width=8, height=6, spp=1)
    live = LiveRenderer(scene, config, spp=1, device="cpu")
    jlive = JLiveRenderer(jscene, jconfig, spp=1)
    for req in EDITS:
        assert live.edit(*req) and jlive.edit(*req), req
    for req in REFUSED:
        assert not live.edit(*req) and not jlive.edit(*req), req
    assert live._apply_edits() and jlive._apply_edits()
    assert not live._apply_edits()
    for kind, (get, _) in _EDITS.items():
        ours, theirs = get(live.scene), np.asarray(get(jlive.scene))
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=kind)
    assert live.scene.emitters.radiance[0].tolist() == [2.5, 2.5, 2.5]
    # edit() reads the shapes kept on the host, never the scene's tensors
    tables, live.scene = live.scene, None
    assert live.edit("bsdf_kd", 0, [1.0]) and not live.edit("bsdf_kd", 99, [1.0])
    live.scene = tables


def test_live_view_edit_loop():
    scene, config, _ = make_cornell_box(width=16, height=12, spp=1, device="cpu")
    config = dataclasses.replace(config, max_depth=2)
    live = LiveRenderer(scene, config, spp=100_000, device="cpu")
    port = _free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(live))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    result = {}
    t = threading.Thread(target=lambda: result.update(live.run()), daemon=True)
    t.start()
    try:
        _wait(port, lambda s: s["spp_done"] >= 2)
        assert _get(port, "/frame")[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"live view" in _get(port, "/")
        _post(port, "/control", b"pause")
        a = _wait(port, lambda s: s["status"] == "paused")
        time.sleep(0.5)
        assert json.loads(_get(port, "/status"))["spp_done"] == a["spp_done"]
        frame_before = _get(port, "/frame")
        _post(port, "/edit", json.dumps({"kind": "emitter_radiance", "index": 0,
                                         "value": [40.0, 2.0, 2.0]}).encode())
        _post(port, "/control", b"resume")
        st = _wait(port, lambda s: s["generation"] == 1 and s["spp_done"] >= 2)
        assert st["status"] in ("rendering", "paused")
        assert _get(port, "/frame") != frame_before
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/edit", b'{"kind": "nope", "index": 0, "value": [1]}')
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/edit", b"not json")
    finally:
        _post(port, "/control", b"stop")
        t.join(timeout=120)
        httpd.shutdown()
        httpd.server_close()
    assert not t.is_alive() and live.state()["status"] == "stopped"
    assert result["spp_done"] >= 2 and result["composite"].shape == (12, 16, 3)
    assert np.isfinite(result["composite"]).all() and result["composite"].mean() > 0
    assert (result["weights"] > 0).all()


def test_render_serve_cli(tmp_path, capsys):
    xml = cornell_box_xml(tmp_path, width=8, height=6, spp=100_000)
    port = _free_port()
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main(
        ["render", str(xml), "--serve", "--port", str(port), "--device", "cpu", "--depth", "2",
         "-o", str(tmp_path / "live")])), daemon=True)
    t.start()
    deadline = time.time() + 60
    while True:  # the server starts after the scene is built
        try:
            _wait(port, lambda s: s["spp_done"] >= 1)
            break
        except urllib.error.URLError:
            assert time.time() < deadline
            time.sleep(0.1)
    _post(port, "/control", b"stop")
    t.join(timeout=120)
    assert not t.is_alive() and rc == [0]
    img = read_exr(tmp_path / "live.exr")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all() and img.mean() > 0
    assert (tmp_path / "live.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"live view at http://127.0.0.1:{port}/" in capsys.readouterr().out


def test_concurrent_edits_all_apply():
    scene, config, _ = make_cornell_box(width=8, height=6, spp=1, device="cpu")
    config = dataclasses.replace(config, max_depth=1)
    live = LiveRenderer(scene, config, spp=100_000, device="cpu")
    rows = scene.bsdfs.kd.shape[0]
    port = _free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(live))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    loop = threading.Thread(target=live.run, daemon=True)
    n_edits, done = 40, threading.Event()

    def editor(row):
        for k in range(n_edits):
            _post(port, "/edit", json.dumps({"kind": "bsdf_kd", "index": row,
                                             "value": [row + k / n_edits]}).encode())

    def reader():
        while not done.is_set():
            _get(port, "/status")
            _get(port, "/frame")

    editors = [threading.Thread(target=editor, args=(r,)) for r in range(rows)]
    readers = [threading.Thread(target=reader) for _ in range(os.cpu_count() or 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop.start()
        for th in readers + editors:
            th.start()
        for th in editors:
            th.join(timeout=120)
        done.set()
        for th in readers:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        live.control("stop")
        loop.join(timeout=120)
        httpd.shutdown()
        httpd.server_close()
    assert not any(th.is_alive() for th in [loop, *editors, *readers])
    live._apply_edits()  # edits queued after the loop's last round
    want = torch.tensor([[r + (n_edits - 1) / n_edits] * 3 for r in range(rows)])
    torch.testing.assert_close(live.scene.bsdfs.kd, want, rtol=0, atol=0)
    assert live.state()["generation"] >= 1
