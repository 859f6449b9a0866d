"""The port's ONNX host stages (DWPose, face embedding, SAM, the face
detector, the ONNX map processors) against the JAX package's, and their CLI
wiring.

The JAX stages run on the JAX executor and call OpenCV (the letterbox
resize, the dwpose affine crop, the renderers, the face warp); the port runs
on its own executor on the CPU with one OpenCV-free path. What each
comparison holds, and why:

* pure-numpy steps (grid decode, NMS, SimCC decode, the whole-body to
  OpenPose layout, SCRFD decode, Umeyama, the SAM filters and point grid):
  equal to 1e-6;
* the letterbox resize: within 1 grey level (``cv2.resize`` works in fixed
  point, the port in float);
* the dwpose crop: within 1 grey level wherever the 2x2 source footprint
  lies inside the frame, the border being where ``cv2.warpAffine`` blends
  with black and the numpy warp clamps; ``warp_affine`` equals the JAX
  module's own numpy branch exactly;
* renders of poses inside the frame: the same pixels (the port
  reimplements OpenCV's rasterisers), held at 99.9 % of the frame; where
  2-px hand lines cross the frame's edge OpenCV's thick line differs at the
  edge, held at 98 % (measured 98.4 % in the whole-frame-box case);
* processors end to end on constant-output graphs (the JAX test's
  ReduceMean * 0 + table construction): boxes and keypoints within 1e-3 px,
  dwpose maps at 99.9 % equal pixels (98 % without a detection, whose
  whole-frame box puts hand lines across the edge), face embeddings at
  cosine 0.999
  against the JAX extractor (1e-5 relative with its numpy warp), SAM,
  face-detector and depth maps within 1 grey level.
"""

import sys

import numpy as np
import pytest
import torch

import musev_tpu.io.dwpose as jdw
import musev_tpu.io.face_emb as jfe
import musev_tpu.io.processors as jproc
import musev_tpu.io.sam as jsam
from musev_tpu.onnx.runtime import OnnxModel as JOnnx
from musev_torch.io import dwpose as dw
from musev_torch.io import face_emb as fe
from musev_torch.io import processors as proc
from musev_torch.io import sam
from musev_torch.onnx import standins
from musev_torch.onnx.proto import Graph, Model, Node, encode_model, parse_model, save_model
from musev_torch.onnx.runtime import OnnxModel

RENDER_SHARE = 0.999  # equal pixels of a render against the OpenCV one
# the same where 2-px hand lines cross the frame's edge (a whole-frame box
# puts keypoints outside it), where OpenCV's thick line differs
EDGE_RENDER_SHARE = 0.98
# face embeddings against the JAX extractor's, whose crop OpenCV warps
# (measured 0.99982 on noise frames, where interpolation differences show most)
FACE_COS = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both(model: Model):
    """The JAX executor and the port's (CPU) on the same encoded bytes."""
    data = encode_model(model)
    from musev_tpu.onnx.proto import parse_model as j_parse

    return JOnnx(j_parse(data)), OnnxModel(parse_model(data), device="cpu")


def constant_graph(input_name, input_shape, tables: dict) -> Model:
    """The JAX test's constant-output graph: each output is its table plus
    the input's mean times 0."""
    nodes = [Node("ReduceMean", [input_name], ["r"], {"keepdims": 0}),
             Node("Mul", ["r", "zero"], ["rz"], {})]
    inits = {"zero": np.asarray(0.0, np.float32)}
    for name, table in tables.items():
        nodes.append(Node("Add", [f"{name}_t", "rz"], [name], {}))
        inits[f"{name}_t"] = np.asarray(table, np.float32)
    return Model(Graph(nodes, inits, [(input_name, list(input_shape))], list(tables), "c"))


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


# -- pure-numpy steps -----------------------------------------------------------------


def test_yolox_decode_and_nms_match_jax():
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((8400, 85)).astype(np.float32)
    np.testing.assert_array_equal(dw.yolox_grid_decode(raw, (640, 640)),
                                  jdw.yolox_grid_decode(raw, (640, 640)))
    xy = rng.uniform(0, 500, (200, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, (200, 2))], 1).astype(np.float32)
    scores = rng.uniform(size=200).astype(np.float32)
    for thr in (0.3, 0.45, 0.7):
        assert dw.nms(boxes, scores, thr) == jdw.nms(boxes, scores, thr)


def test_simcc_decode_and_openpose_layout_match_jax():
    rng = np.random.default_rng(1)
    sx = rng.standard_normal((2, 133, 576)).astype(np.float32)
    sy = rng.standard_normal((2, 133, 768)).astype(np.float32)
    for got, want in zip(dw.simcc_decode(sx, sy), jdw.simcc_decode(sx, sy)):
        np.testing.assert_array_equal(got, want)
    kpts = rng.uniform(0, 500, (2, 133, 2)).astype(np.float32)
    scores = rng.uniform(size=(2, 133)).astype(np.float32)
    got, want = dw.wholebody_to_openpose(kpts, scores, 512, 384), \
        jdw.wholebody_to_openpose(kpts, scores, 512, 384)
    for field in ("bodies", "body_scores", "hands", "hand_scores", "faces", "face_scores"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-6)


def _scrfd_tables(input_size=(64, 64), face=(32.0, 28.0, 12.0, 0.9)):
    """The 9 SCRFD head tensors with one face (the JAX test's layout)."""
    iw, ih = input_size
    sizes = [(ih // s) * (iw // s) * 2 for s in (8, 16, 32)]
    scores = [np.zeros((n, 1), np.float32) for n in sizes]
    bboxes = [np.zeros((n, 4), np.float32) for n in sizes]
    kpss = [np.zeros((n, 10), np.float32) for n in sizes]
    if face is not None:
        cx, cy, half, score = face
        gw = iw // 8
        idx = ((int(cy) // 8) * gw + (int(cx) // 8)) * 2
        ax, ay = (int(cx) // 8) * 8, (int(cy) // 8) * 8
        scores[0][idx, 0] = score
        bboxes[0][idx] = [(ax - (cx - half)) / 8, (ay - (cy - half)) / 8,
                          ((cx + half) - ax) / 8, ((cy + half) - ay) / 8]
        kps = (jfe.ARCFACE_DST - 56.0) * (2 * half / 112.0) + [cx, cy]
        kpss[0][idx] = ((kps - [ax, ay]) / 8).reshape(-1)
    return scores + bboxes + kpss


def test_scrfd_decode_umeyama_and_warp_match_jax(monkeypatch):
    outs = _scrfd_tables((64, 64))
    for got, want in zip(fe.scrfd_decode(outs, (64, 64)), jfe.scrfd_decode(outs, (64, 64))):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(2)
    src = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    dst = fe.ARCFACE_DST * 1.3 + 4
    np.testing.assert_array_equal(fe.umeyama_similarity(src, dst), jfe.umeyama_similarity(src, dst))
    img = _frames(3, 1, 90, 120)[0]
    kps = fe.ARCFACE_DST * 0.8 + [20, 5]
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX module's numpy branch
    np.testing.assert_array_equal(fe.norm_crop(img, kps, 112), jfe.norm_crop(img, kps, 112))


def test_sam_filters_preprocess_and_grid_match_jax():
    rng = np.random.default_rng(4)
    for logits in (rng.standard_normal((40, 50)) * 3, 1.0 - 0.02 * np.arange(100)):
        assert sam.stability_score(logits, 0.0, 1.0) == jsam.stability_score(logits, 0.0, 1.0)
    frame = _frames(5, 1, 30, 60)[0]
    for got, want in zip(sam.sam_preprocess(frame, 64), jsam.sam_preprocess(frame, 64)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(sam.build_point_grid(8, (576, 1024)),
                                  jsam.build_point_grid(8, (576, 1024)))


# -- the OpenCV-free steps --------------------------------------------------------------


@pytest.mark.parametrize("hw", [(576, 576), (90, 160), (480, 270)])
def test_letterbox_within_one_grey_level_of_opencv(hw):
    img = _frames(6, 1, *hw)[0]
    got, r = dw.letterbox(img, (640, 640))
    want, r_j = jdw.letterbox(img, (640, 640))
    assert r == r_j and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_dwpose_crop_within_one_grey_level_inside_the_frame():
    img = _frames(7, 1, 576, 576)[0]
    for box in ([100, 50, 400, 500], [200, 60, 260, 300]):
        c, s = dw._bbox_center_scale(np.asarray(box, np.float32), 288 / 384)
        got = dw._crop_affine(img, c, s, (288, 384)).astype(int)
        want = jdw._crop_affine(img, c, s, (288, 384))
        mat = dw.affine_from_points(
            np.float32([c, c + [0, -s[1] / 2], c + [s[0] / 2, 0]]),
            np.float32([[144, 192], [144, 0], [288, 192]]))
        inv = np.linalg.inv(np.vstack([mat, [0, 0, 1]]))[:2]
        ys, xs = np.mgrid[0:384, 0:288]
        sx, sy = (np.stack([xs, ys, np.ones_like(xs)], -1) @ inv.T).transpose(2, 0, 1)
        inside = (sx >= 0) & (sx <= 574) & (sy >= 0) & (sy <= 574)
        assert inside.mean() > 0.5
        assert np.abs(got - want)[inside].max() <= 1


def test_renders_match_opencv():
    rng = np.random.default_rng(8)
    for _ in range(4):
        kpts = rng.uniform(30, 546, (2, 133, 2)).astype(np.float32)
        scores = rng.uniform(size=(2, 133)).astype(np.float32)
        pose = dw.wholebody_to_openpose(kpts, scores, 576, 576)
        got, want = dw.render_pose(pose, 576, 576), jdw.render_pose(pose, 576, 576)
        assert want.any()
        assert (got == want).all(-1).mean() >= RENDER_SHARE
    assert not dw.render_pose(dw.wholebody_to_openpose(
        kpts, np.zeros_like(scores), 576, 576), 64, 64).any()


# -- processors end to end -----------------------------------------------------------


def _dwpose_graphs(person=True, hw=(96, 128)):
    det = np.zeros((1, 8400, 6), np.float32)
    if person:
        r = 640 / max(hw)
        i = 80 * 80 + 40 * 40 + 5 * 20 + 6
        det[0, i] = [0.3, 0.6, np.log(40 * r / 32), np.log(70 * r / 32), 0.9, 0.9]
    sx = np.zeros((1, 133, 576), np.float32)
    sy = np.zeros((1, 133, 768), np.float32)
    peaks = standins.simcc_peaks()
    sx[0, np.arange(133), peaks[:, 0]] = 1.0
    sy[0, np.arange(133), peaks[:, 1]] = 1.0
    return (constant_graph("images", (1, 3, 640, 640), {"out": det}),
            constant_graph("input", (1, 3, 384, 288), {"simcc_x": sx, "simcc_y": sy}))


@pytest.mark.parametrize("person", [True, False])
def test_dwpose_processor_matches_jax(person):
    det_m, pose_m = _dwpose_graphs(person)
    (jdet, det), (jpose, pose) = both(det_m), both(pose_m)
    frames = _frames(9, 2, 96, 128)
    boxes, jboxes = dw.detect_persons(det, frames[0]), jdw.detect_persons(jdet, frames[0])
    assert boxes.shape == jboxes.shape == ((1, 4) if person else (0, 4))
    np.testing.assert_allclose(boxes, jboxes, atol=1e-3)
    got = dw.DWPoseProcessor(det, pose).detect_frame(frames[0])
    want = jdw.DWPoseProcessor(jdet, jpose).detect_frame(frames[0])
    np.testing.assert_allclose(got.bodies * [128, 96], want.bodies * [128, 96], atol=1e-3)
    np.testing.assert_allclose(got.hands * [128, 96], want.hands * [128, 96], atol=1e-3)
    maps = dw.DWPoseProcessor(det, pose)(frames)
    jmaps = jdw.DWPoseProcessor(jdet, jpose)(frames)
    assert maps.shape == jmaps.shape == (2, 96, 128, 3) and jmaps.any()
    share = (maps == jmaps).all(-1).mean()
    assert share >= (RENDER_SHARE if person else EDGE_RENDER_SHARE), share


def test_face_emb_extractor_matches_jax(monkeypatch):
    det_m = constant_graph("input.1", (1, 3, 64, 64),
                           {f"o{i}": t for i, t in enumerate(_scrfd_tables((64, 64)))})
    w = np.random.default_rng(10).standard_normal((48, 3 * 112 * 112)).astype(np.float32)
    rec_m = Model(Graph([Node("Flatten", ["img"], ["f"], {"axis": 1}),
                         Node("Gemm", ["f", "w"], ["emb"], {"transB": 1})],
                        {"w": w * 1e-2}, [("img", [1, 3, 112, 112])], ["emb"], "rec"))
    (jdet, det), (jrec, rec) = both(det_m), both(rec_m)
    imgs = _frames(11, 2, 128, 128)
    for norm in (False, True):
        got = fe.FaceEmbExtractor(det, rec, norm=norm, det_input_size=(64, 64))(imgs)
        want = jfe.FaceEmbExtractor(jdet, jrec, norm=norm, det_input_size=(64, 64))(imgs)
        cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
        assert got.shape == (2, 48) and cos.min() >= FACE_COS, cos
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX module's numpy warp
    got = fe.FaceEmbExtractor(det, rec, det_input_size=(64, 64))(imgs)
    want = jfe.FaceEmbExtractor(jdet, jrec, det_input_size=(64, 64))(imgs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    none = constant_graph("input.1", (1, 3, 64, 64),
                          {f"o{i}": t for i, t in enumerate(_scrfd_tables((64, 64), None))})
    emb = fe.FaceEmbExtractor(both(none)[1], rec, det_input_size=(64, 64))(imgs[0])
    assert emb.shape == (1, 48) and np.isfinite(emb).all()  # the no-face fallback


def test_sam_face_detector_and_depth_processors_match_jax():
    (jenc, enc), (jdec, dec) = (both(standins.sam_encoder_graph(size=64)),
                                both(standins.sam_decoder_graph(size=64, radius=24.0)))
    frames = _frames(12, 2, 48, 64)
    kw = dict(encoder_size=64, points_per_side=4, min_mask_area=4, seed=3)
    got = sam.SamAutomaticMaskProcessor(enc, dec, **kw)(frames)
    want = jsam.SamAutomaticMaskProcessor(jenc, jdec, **kw)(frames)
    assert got.shape == frames.shape and want.any()
    assert np.abs(got.astype(int) - want).max() <= 1

    raw = np.zeros((1, 84, 6), np.float32)  # 64 + 16 + 4 anchors of a 64x64 input
    raw[0, 4 * 8 + 4] = [0.0, 0.0, np.log(2.0), np.log(2.0), 0.9, 0.9]
    jdet, det = both(constant_graph("images", (1, 3, 64, 64), {"out": raw}))
    square = _frames(16, 1, 64, 64)
    got = sam.FaceDetectorProcessor(det, input_size=(64, 64))(square)
    want = jsam.FaceDetectorProcessor(jdet, input_size=(64, 64))(square)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 24:40, 24:40] == 255).all()

    jdepth, depth = both(standins.depth_graph(size=64))
    got = proc.OnnxImageProcessor(depth, "depth", input_size=64)(frames)
    want = jproc.OnnxImageProcessor(jdepth, "depth", input_size=64)(frames)
    assert got.shape == frames.shape and np.abs(got.astype(int) - want).max() <= 1


def test_processor_names_match_jax():
    assert proc._NAME_TO_KIND == jproc._NAME_TO_KIND
    assert proc._ONNX_KIND_DEFAULTS == jproc._ONNX_KIND_DEFAULTS
    assert dw._DWPOSE_VARIANTS == jdw._DWPOSE_VARIANTS
    with pytest.raises(ValueError, match="cannot infer"):
        proc.register_onnx_processor("mystery", "m.onnx", device="cpu")


def test_stages_run_on_cuda_unless_given_the_cpu(tmp_path):
    """Without a card the executor, and every stage built from files,
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "det.onnx")
    save_model(_dwpose_graphs()[0], path)
    for call in (lambda: OnnxModel.from_file(path),
                 lambda: dw.register_dwpose(path, path, names=["dwpose"]),
                 lambda: fe.build_face_emb_extractor(path, path),
                 lambda: sam.register_face_detector(path),
                 lambda: proc.register_onnx_processor("depth", path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- CLI wiring --------------------------------------------------------------------------


class FramesReader:
    """``VideoReader``'s interface over frames in memory."""

    def __init__(self, frames):
        self.frames = frames
        self.num_frames, self.height, self.width = frames.shape[:3]

    def windows(self, time_size: int, overlap: int = 0, sample_rate: int = 1):
        for lo in range(0, self.num_frames, time_size - overlap):
            yield self.frames[lo:lo + time_size:sample_rate]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


TINY = ["--tiny", "--device", "cpu", "--time_size", "4", "--context_frames", "4",
        "--context_overlap", "0", "--num_inference_steps", "2",
        "--video_num_inference_steps", "2", "--seed", "5"]


def test_text2video_cli_extracts_the_face_embedding(tmp_path, monkeypatch):
    """--face_det_onnx/--face_rec_onnx: the CLI reads both files, takes the
    condition image's face embedding and hands it to the FaceID branch
    (the JAX test_face_emb.py CLI wiring test, on the port)."""
    import dataclasses

    from PIL import Image

    from musev_torch.cli import text2video as t2v
    from musev_torch.pipelines.pipeline import MusevPipeline

    orig_shrink = t2v._shrink_preset

    def shrink_face(preset):
        preset = orig_shrink(preset)
        preset.unet_cfg = dataclasses.replace(preset.unet_cfg, need_ip_adapter_face=True,
                                              ip_adapter_face_dim=32)
        preset.ip_adapter_face_id_dim = 48
        return preset

    monkeypatch.setattr(t2v, "_shrink_preset", shrink_face)
    det_m = constant_graph("input.1", (1, 3, 640, 640),
                           {f"o{i}": t for i, t in enumerate(
                               _scrfd_tables((640, 640), (320.0, 300.0, 80.0, 0.9)))})
    w = np.random.default_rng(13).standard_normal((48, 3 * 112 * 112)).astype(np.float32)
    rec_m = Model(Graph([Node("Flatten", ["img"], ["f"], {"axis": 1}),
                         Node("Gemm", ["f", "w"], ["emb"], {"transB": 1})],
                        {"w": w * 1e-2}, [("img", [1, 3, 112, 112])], ["emb"], "rec"))
    save_model(det_m, str(tmp_path / "det.onnx"))
    save_model(rec_m, str(tmp_path / "rec.onnx"))
    img = _frames(14, 1, 64, 64)[0]
    Image.fromarray(img).save(tmp_path / "cond.png")
    (tmp_path / "tasks.csv").write_text(
        f"name,prompt,condition_images\nt0,a girl,{tmp_path / 'cond.png'}\n")
    seen = []
    real = MusevPipeline.text2video

    def record(self, *a, **k):
        seen.append(k.get("face_emb"))
        return real(self, *a, **k)

    monkeypatch.setattr(MusevPipeline, "text2video", record)
    written = t2v.main(["--test_data_path", str(tmp_path / "tasks.csv"), "--output_dir",
                        str(tmp_path / "out"), "--model_name", "musev_referencenet",
                        "--height", "64", "--width", "64", "--face_det_onnx",
                        str(tmp_path / "det.onnx"), "--face_rec_onnx", str(tmp_path / "rec.onnx"),
                        "--face_emb_norm", *TINY])
    assert len(written) == 1 and len(seen) == 1
    extractor = fe.build_face_emb_extractor(str(tmp_path / "det.onnx"), str(tmp_path / "rec.onnx"),
                                            norm=True, device="cpu")
    np.testing.assert_allclose(seen[0], extractor(img[None]), rtol=1e-6)
    assert seen[0].shape == (1, 48) and np.isclose(np.linalg.norm(seen[0]), 1.0)


def test_video2video_cli_runs_the_dwpose_processor(tmp_path, monkeypatch):
    """--controlnet_name dwpose with the two ONNX files: the CLI registers
    the dwpose family on its device and the pipeline's control maps are
    the processor's maps of the source frames."""
    import musev_torch.io.processors as processors
    import musev_torch.io.video as video_io
    from musev_torch.cli import text2video as t2v
    from musev_torch.cli import video2video as v2v

    det_m, pose_m = _dwpose_graphs(hw=(64, 64))
    save_model(det_m, str(tmp_path / "det.onnx"))
    save_model(pose_m, str(tmp_path / "pose.onnx"))
    source = _frames(15, 4, 64, 64)
    monkeypatch.setattr(video_io, "VideoReader", lambda path: FramesReader(source))
    monkeypatch.setattr(t2v, "native_available", lambda: True)
    kept = {}
    monkeypatch.setattr(t2v, "write_video", lambda path, f, fps: kept.__setitem__(path, f))
    calls = []
    real_get = processors.get_processor

    def get(name):
        fn = real_get(name)

        def wrapped(frames):
            out = fn(frames)
            calls.append((np.array(frames), out))
            return out

        return wrapped

    monkeypatch.setattr(processors, "get_processor", get)
    (tmp_path / "tasks.csv").write_text("name,prompt,video_path\ndance,a dancer,in-memory\n")
    written = v2v.main(["--test_data_path", str(tmp_path / "tasks.csv"), "--output_dir",
                        str(tmp_path / "out"), "--controlnet_name", "dwpose",
                        "--dwpose_det_onnx", str(tmp_path / "det.onnx"), "--dwpose_pose_onnx",
                        str(tmp_path / "pose.onnx"), *TINY])
    assert len(written) == 1 and kept[written[0]].shape == (5, 64, 64, 3)
    assert calls and all(out.shape == frames.shape for frames, out in calls)
    det = OnnxModel(parse_model(encode_model(det_m)), device="cpu")
    pose = OnnxModel(parse_model(encode_model(pose_m)), device="cpu")
    frames, out = calls[0]
    np.testing.assert_array_equal(out, dw.DWPoseProcessor(det, pose)(frames))
    assert out.any()
