"""The port's serving stack on the CPU at a small size (the (1, 1, 1, 1)
encoder at 64 px, f32, batch 2, the 120-vertex body): ``BatchingPredictor``
(the cases of ``tests/test_predictor_viz.py``'s batching tests, each result
held against a direct ``Predictor.predict`` within atol 1e-5), the HTTP
front end and its 400s (a PNG and a JPEG), ``decode_image`` against
OpenCV, the ``torch.export`` artifact (against the live predictor within
atol 1e-5, int8 within 5e-3; the loader in a fresh process imports no
model code), and ``cli.export_model`` followed by ``cli.serve``'s server.
"""
import io
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.infer.export import ExportedPredictor, export_predictor
from human_pose_estimation_tpu_torch.infer.http_server import make_server
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.infer.serving import BatchingPredictor
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model
from human_pose_estimation_tpu_torch.utils.image import decode_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
CFG = dict(img_size=IMG, batch_size=2, encoder_dtype="float32", encoder_stage_sizes="1,1,1,1", seed=4)


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    """A seeded predictor (no checkpoint under checkpoint_dir)."""
    empty = tmp_path_factory.mktemp("no_ckpt")
    return Predictor(Config(checkpoint_dir=str(empty), **CFG), smpl=synthetic_model(num_verts=120, seed=0),
                     device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, tiny_model):
    """(path, metadata, the flags) of a CPU artifact that cli.export_model
    writes from the seeded model of ``predictor``'s configuration."""
    from human_pose_estimation_tpu.core.smpl import save_model_npz

    from human_pose_estimation_tpu_torch.cli import export_model

    tmp = tmp_path_factory.mktemp("artifact")
    save_model_npz(tiny_model, str(tmp / "model.npz"))
    flags = ["--smpl_model_path", str(tmp / "model.npz"), "--checkpoint_dir", str(tmp / "none")]
    for key, value in CFG.items():
        flags += [f"--{key}", str(value)]
    path = str(tmp / "model.pt2")
    meta = export_model.main(flags + ["--out", path, "--platforms", "cpu"], device="cpu")
    return path, meta, flags


def _uint8(seed, n, h=IMG, w=IMG):
    return np.random.RandomState(seed).randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)


def _submit_all(bp, images):
    futures = [None] * len(images)

    def submit(i):
        futures[i] = bp.submit(images[i])

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return futures


def _close(a, b, atol=1e-5):
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


def test_batching_predictor_microbatching(predictor):
    """Concurrent submits coalesce into padded batches; every result is the
    direct predict's; close() stops new submits."""
    images = _uint8(0, 5)
    direct = predictor.predict(images)
    bp = BatchingPredictor(predictor, max_latency_ms=30.0)
    futures = _submit_all(bp, images)
    for i, f in enumerate(futures):
        _close(f.result(timeout=60), {k: v[i] for k, v in direct.items()})
    assert bp.stats["requests"] == 5
    assert bp.stats["batches"] >= 3  # batch 2
    assert bp.stats["padded_slots"] == 2 * bp.stats["batches"] - 5
    _close(bp.predict_single_image(images[0]), {k: v[0] for k, v in direct.items()})
    bp.close()
    with pytest.raises(RuntimeError, match="closed"):
        bp.submit(images[0])


@pytest.mark.parametrize("depth", [1, 3])
def test_batching_predictor_pipelined(predictor, depth):
    """pipeline_depth keeps batches in flight and resolves the futures in
    order with the direct predict's results."""
    images = _uint8(1, 9)
    direct = predictor.predict(images)
    done = []
    bp = BatchingPredictor(predictor, max_latency_ms=10.0, pipeline_depth=depth)
    futures = [bp.submit(im) for im in images]
    for i, f in enumerate(futures):
        f.add_done_callback(lambda _, i=i: done.append(i))
    for i, f in enumerate(futures):
        _close(f.result(timeout=60), {k: v[i] for k, v in direct.items()})
    bp.close()
    assert done == sorted(done)  # FIFO resolution
    assert bp.stats["requests"] == len(images)


def test_batching_predictor_blocking_only_predictor(predictor):
    """A predictor without the async API is served blocking at fetch."""
    images = _uint8(2, 4)
    direct = predictor.predict(images)

    class BlockingOnly:
        batch_size = predictor.batch_size

        def predict(self, imgs):
            return predictor.predict(imgs)

    bp = BatchingPredictor(BlockingOnly(), max_latency_ms=10.0, pipeline_depth=2)
    for i, f in enumerate([bp.submit(im) for im in images]):
        _close(f.result(timeout=60), {k: v[i] for k, v in direct.items()})
    bp.close()


def test_batching_predictor_close_fails_leftover_futures(predictor):
    """A request that reaches the queue after the dispatcher stopped fails
    on close() instead of hanging its caller; a predictor's error, or
    images of two shapes, reach every future of their batch, and the
    dispatcher serves on."""
    from concurrent.futures import Future

    bp = BatchingPredictor(predictor, max_latency_ms=1.0)
    bp.close()
    assert not bp._thread.is_alive()
    late: Future = Future()
    bp._queue.put((_uint8(3, 1)[0], late))  # a submit() that raced the dispatcher's last look
    bp.close()
    with pytest.raises(RuntimeError, match="closed"):
        late.result(timeout=1)

    class Failing:
        batch_size = predictor.batch_size

        def predict_async(self, images):
            raise ValueError("no device")

        def predict_fetch(self, handle):
            raise AssertionError("never dispatched")

    bad = BatchingPredictor(Failing(), max_latency_ms=20.0)
    futures = [bad.submit(im) for im in _uint8(4, 2)]
    for f in futures:
        with pytest.raises(ValueError, match="no device"):
            f.result(timeout=60)
    bad.close()

    # two shapes in one batch (batch 2, a long deadline): both futures
    # fail, and the dispatcher serves on
    bp = BatchingPredictor(predictor, max_latency_ms=5000.0)
    mixed = [bp.submit(np.zeros((IMG + 1, IMG, 3), np.uint8)), bp.submit(np.zeros((IMG, IMG, 3), np.uint8))]
    for f in mixed:
        with pytest.raises(ValueError):
            f.result(timeout=60)
    images = _uint8(3, 2)
    direct = predictor.predict(images)
    for i, f in enumerate([bp.submit(im) for im in images]):
        _close(f.result(timeout=60), {k: v[i] for k, v in direct.items()})
    bp.close()


# ---------------------------------------------------------------------------
# decode_image


def _png(img, filters):
    """An 8-bit PNG of ``img`` ((H, W, C) uint8, C in 1, 3, 4) with the row
    filter ``filters[y % len(filters)]`` on row y, written with zlib."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prior = x[y - 1] if y else np.zeros(w * c, np.int32)
        cur = x[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            r = cur
        elif f == 1:
            r = cur - left
        elif f == 2:
            r = cur - prior
        elif f == 3:
            r = cur - ((left + prior) >> 1)
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            r = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([f]) + (r & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _cv2_rgb(raw):
    cv2 = pytest.importorskip("cv2")
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_image_matches_cv2_on_its_pngs(channels):
    """PNGs from cv2.imencode (gray, RGB, RGBA; libpng picks the filters):
    element-equal to IMREAD_COLOR + BGR2RGB (gray repeated, alpha dropped)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(channels)
    img = (rng.rand(37, 53, channels) * 255).astype(np.uint8)
    img[5:20, 10:30] = 200  # flat areas, where libpng's filter choice varies
    raw = cv2.imencode(".png", img[..., 0] if channels == 1 else img)[1].tobytes()
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(raw))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_decode_image_png_row_filters(filt):
    """Every row with one filter (None, Sub, Up, Average, Paeth), and all
    five in turn, for gray, RGB and RGBA: element-equal to OpenCV's decode
    and to the image written."""
    rng = np.random.RandomState(10 + filt)
    for c in (1, 3, 4):
        img = (rng.rand(19, 23, c) * 255).astype(np.uint8)
        want = np.repeat(img, 3, axis=2) if c == 1 else img[..., :3]
        for filters in ((filt,), (filt, 0, 1, 2, 3, 4)):
            raw = _png(img, filters)
            got = decode_image(raw)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, _cv2_rgb(raw))


def test_decode_image_other_forms_go_to_opencv():
    """A JPEG and a 16-bit PNG take OpenCV's decoder; junk raises."""
    cv2 = pytest.importorskip("cv2")
    img = (np.random.RandomState(5).rand(30, 20, 3) * 255).astype(np.uint8)
    for raw in (cv2.imencode(".jpg", img)[1].tobytes(), cv2.imencode(".png", img.astype(np.uint16) * 257)[1].tobytes()):
        np.testing.assert_array_equal(decode_image(raw), _cv2_rgb(raw))
    with pytest.raises(ValueError, match="decode"):
        decode_image(b"not an image")


# ---------------------------------------------------------------------------
# the HTTP front end


def _post(port, query="", body=b"", headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict{query}", data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_http_server_endpoints(predictor):
    """/predict in the npz, raw and json forms (query and Accept header),
    the outputs filter, the 400s, /healthz; a PNG (decoded by the port) and a JPEG
    (decoded by OpenCV), each equal to the direct predict of its decoded
    pixels within atol 1e-5."""
    cv2 = pytest.importorskip("cv2")
    bp = BatchingPredictor(predictor, max_latency_ms=20.0)
    httpd = make_server(bp, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img = _uint8(6, 1)[0]
        png = _png(img, (1,))
        jpg = cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()
        for raw in (png, jpg):
            direct = predictor.predict(decode_image(raw)[None])
            status, ctype, body = _post(port, "?format=raw", raw)
            assert status == 200 and ctype == "application/x-npz"
            z = np.load(io.BytesIO(body))
            _close({k: z[k] for k in z.files}, {k: v[0] for k, v in direct.items()})
            status, _, body = _post(port, "", raw)  # compressed npz: the same arrays
            zc = np.load(io.BytesIO(body))
            for k in z.files:
                np.testing.assert_array_equal(zc[k], z[k])
        _, ctype, body = _post(port, "", png, {"Accept": "application/json"})
        out = json.loads(body)
        assert ctype == "application/json" and set(out) == {"generated_cams", "generated_joints", "theta"}
        assert len(out["generated_cams"]) == 3 and len(out["generated_joints"]) == 14
        _, _, body = _post(port, "?format=json&outputs=generated_joints", png)
        assert set(json.loads(body)) == {"generated_joints"}
        _, _, body = _post(port, "?outputs=generated_cams,theta", png)
        assert set(np.load(io.BytesIO(body)).files) == {"generated_cams", "theta"}
        for query, raw in (("?format=msgpack", png), ("?outputs=nope", png), ("", b"not an image")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, query, raw)
            assert err.value.code == 400 and "error" in json.loads(err.value.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["requests"] >= 7 and health["batch_size"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        bp.close()


# ---------------------------------------------------------------------------
# the artifact


def test_export_roundtrip(predictor, artifact):
    """The artifact against the live predictor within atol 1e-5: a batch
    of 5 (padded and cut into 3 batches of 2) and predict_single_image."""
    path, meta, _ = artifact
    assert meta["batch"] == 2 and meta["platforms"] == ["cpu"] and meta["encoder_int8"] is False
    assert os.path.exists(path) and json.load(open(path + ".json")) == meta
    ep = ExportedPredictor(path, device="cpu")
    images = _uint8(7, 5)
    _close(ep.predict(images), predictor.predict(images))
    verts, cams, joints = ep.predict_single_image(images[0])
    np.testing.assert_allclose(verts[0], predictor.predict(images[:1])["generated_verts"][0], atol=1e-5, rtol=0)
    assert cams.shape == (1, 3) and joints.shape == (1, 14, 3)


def test_exported_predictor_refuses_a_platform_it_lacks(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="cuda"):
        ExportedPredictor(artifact[0], device="cuda")


def test_export_roundtrip_int8(predictor, tmp_path):
    """A calibrated int8 predictor exports with its int8 weights and scales
    inside; the artifact matches the live int8 predictor within atol 5e-3
    (the JAX test's tolerance between two compiles of the int8 graph;
    measured on the CPU: equal)."""
    calib = _uint8(8, 2)
    p = Predictor(predictor.config, smpl=predictor.smpl, variables=predictor.hmr.state_dict(),
                  mean_theta=predictor.mean_theta, device="cpu", encoder_int8=True, calibration_images=calib)
    path = str(tmp_path / "int8.pt2")
    assert export_predictor(p, path, platforms=("cpu",))["encoder_int8"] is True
    images = _uint8(9, 2)
    _close(ExportedPredictor(path, device="cpu").predict(images), p.predict(images), atol=5e-3)


def test_exported_loader_imports_no_model_code(predictor, artifact):
    """A fresh process that imports the loader, loads the artifact and
    predicts holds no module of the port's models, core, training or
    body model, and no JAX."""
    path, _, _ = artifact
    images = _uint8(7, 3)
    want = predictor.predict(images)["generated_joints"]
    np.save(os.path.join(os.path.dirname(path), "images.npy"), images)
    code = (
        "import sys, numpy as np\n"
        "from human_pose_estimation_tpu_torch.infer.export import ExportedPredictor\n"
        f"ep = ExportedPredictor({path!r}, device='cpu')\n"
        f"out = ep.predict(np.load({os.path.join(os.path.dirname(path), 'images.npy')!r}))\n"
        f"np.save({os.path.join(os.path.dirname(path), 'joints.npy')!r}, out['generated_joints'])\n"
        "print(sorted(m for m in sys.modules if m.startswith('human_pose_estimation_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr
    loaded = eval(proc.stdout.strip().splitlines()[-1])
    assert loaded == [
        "human_pose_estimation_tpu_torch", "human_pose_estimation_tpu_torch.infer",
        "human_pose_estimation_tpu_torch.infer.export",
    ], loaded
    got = np.load(os.path.join(os.path.dirname(path), "joints.npy"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cli_export_model_then_serve(artifact, tmp_path, capsys):
    """cli.export_model wrote the CPU artifact (the ``artifact`` fixture);
    cli.serve's server over it answers one request (a PNG, no resize) with
    the artifact's result, then shuts down. --encoder_int8 without
    --calibration exits with the JAX package's message."""
    from human_pose_estimation_tpu_torch.cli import export_model, serve

    out, meta, flags = artifact
    assert meta["platforms"] == ["cpu"] and os.path.exists(out + ".json")
    with pytest.raises(SystemExit, match="--calibration"):
        export_model.main(flags + ["--out", str(tmp_path / "x.pt2"), "--encoder_int8", "true"], device="cpu")

    httpd, batcher, _ = serve.build_server(
        ["--artifact", out, "--port", "0", "--decode_size", "0", "--img_size", str(IMG)], device="cpu"
    )
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img = _uint8(11, 1)[0]
        _, _, body = _post(httpd.server_address[1], "?format=raw", _png(img, (2,)))
        z = np.load(io.BytesIO(body))
        want = batcher.predictor.predict(img[None])
        _close({k: z[k] for k in z.files}, {k: v[0] for k, v in want.items()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    thread.join(timeout=10)
    assert not thread.is_alive() and "warmup done" in capsys.readouterr().out
