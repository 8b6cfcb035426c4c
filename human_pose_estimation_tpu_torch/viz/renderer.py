"""Visualization: mesh rendering, skeleton drawing, preprocessing undo (the
port's own copy of ``human_pose_estimation_tpu/viz/renderer.py``).

A z-buffer rasterizer (perspective projection, per-face flat Lambertian
shading or the reference's three point lights) stands in for the
reference's OpenDR renderer. Flat shading runs in C++
(``native/rasterizer.cpp``, built with g++ at first use) when it can be
built, else in the numpy code below, its specification; the two give
equal masks and images within 1e-12. The training loss uses projected vertices, not
rendered pixels: the rasterizer draws logged images and the closed-loop
synthetic data (``data/synthetic.py``). OpenCV is imported inside the
functions that draw or resize, never with this module.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

MESH_COLORS = {
    0: np.array([0.65098039, 0.74117647, 0.85882353]),  # light blue
    1: np.array([0.9, 0.7, 0.7]),  # light pink
}

_LIGHT_DIR = np.array([-0.4, -0.6, -1.0])
_AMBIENT = 0.35

# The reference lights its meshes with THREE positioned point lights
# (back / left / right, the third at 0.7 intensity), rotated 120° about
# Y, summed with no ambient term (ref src/util/renderer.py:157-192,
# OpenDR LambertianPointLight). Public constants, carried for visual
# parity; used by lighting="points".
_POINT_LIGHTS = [  # (position (model units), intensity)
    (np.array([-200.0, -100.0, -100.0]), 1.0),
    (np.array([800.0, 10.0, 300.0]), 1.0),
    (np.array([-500.0, 500.0, 1000.0]), 0.7),
]
_POINT_LIGHT_YROT = math.radians(120.0)


def _vertex_point_light_shade(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex Lambertian shade from the reference's 3 point lights.

    Returns (V,) in [0, 1]. Vertex normals are area-weighted face-normal
    sums (the standard Gouraud setup; OpenDR's VertNormals equivalent).
    """
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = np.cross(e1, e2)  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)

    rot = _rot_mat("y", math.degrees(_POINT_LIGHT_YROT))
    shade = np.zeros(len(verts))
    for pos, intensity in _POINT_LIGHTS:
        lp = rot @ pos
        to_light = lp - verts
        to_light /= np.maximum(
            np.linalg.norm(to_light, axis=1, keepdims=True), 1e-12
        )
        # double-sided, like the directional path: the z-buffer decides
        # visibility, and back-facing normals on a watertight body mean
        # the camera sees the other side
        shade += intensity * np.abs(np.sum(vn * to_light, axis=1))
    return np.clip(shade, 0.0, 1.0)


def _rot_mat(axis: str, deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rasterize_mesh(
    verts: np.ndarray,  # (V, 3) camera-frame coords (+z into the screen)
    faces: np.ndarray,  # (F, 3) int
    height: int,
    width: int,
    focal: float,
    center: np.ndarray,  # (2,) principal point [cx, cy]
    color: np.ndarray,
    background: Optional[np.ndarray] = None,  # (H, W, 3) float [0, 1]
    use_native: bool = True,
    lighting: str = "directional",  # 'directional' | 'points'
):
    """Z-buffered perspective rasterization.

    lighting='directional': flat shading from one directional light +
    ambient (the C++ rasterizer implements exactly this). lighting='points':
    the reference's 3-point-light Lambertian model with per-vertex
    (Gouraud) shades interpolated per pixel, numpy only.

    ``use_native`` takes the C++ rasterizer (``native/rasterizer.cpp``) for
    flat shading when it can be built, and this numpy implementation
    otherwise. Returns (image (H, W, 3) float [0, 1], mask (H, W) bool).
    """
    if use_native and lighting == "directional":
        from ..native import rasterize_native

        out = rasterize_native(
            np.asarray(verts, np.float64),
            np.asarray(faces, np.int64),
            height,
            width,
            focal,
            np.asarray(center, np.float64),
            np.asarray(color, np.float64),
            _LIGHT_DIR,
            _AMBIENT,
            background,
        )
        if out is not None:
            return out
    verts = np.asarray(verts, np.float64)
    z = np.maximum(verts[:, 2], 1e-6)
    px = focal * verts[:, 0] / z + center[0]
    py = focal * verts[:, 1] / z + center[1]
    pts = np.stack([px, py], axis=1)

    tri = pts[faces]  # (F, 3, 2)
    tri_z = z[faces]  # (F, 3)

    # Face normals & shading in camera space.
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    n_norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(n_norm, 1e-12)
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    lam = np.abs(n @ light)  # double-sided
    shade = np.clip(_AMBIENT + (1 - _AMBIENT) * lam, 0, 1)
    vert_shade = (
        _vertex_point_light_shade(verts, faces) if lighting == "points" else None
    )

    depth = np.full((height, width), np.inf)
    img = (
        background.astype(np.float64).copy()
        if background is not None
        else np.ones((height, width, 3))
    )
    mask = np.zeros((height, width), bool)

    # Per-face bounding-box rasterization (vectorized inside the box).
    x0 = np.clip(np.floor(tri[:, :, 0].min(1)).astype(int), 0, width - 1)
    x1 = np.clip(np.ceil(tri[:, :, 0].max(1)).astype(int), 0, width - 1)
    y0 = np.clip(np.floor(tri[:, :, 1].min(1)).astype(int), 0, height - 1)
    y1 = np.clip(np.ceil(tri[:, :, 1].max(1)).astype(int), 0, height - 1)
    areas = (tri[:, 1, 0] - tri[:, 0, 0]) * (tri[:, 2, 1] - tri[:, 0, 1]) - (
        tri[:, 2, 0] - tri[:, 0, 0]
    ) * (tri[:, 1, 1] - tri[:, 0, 1])

    order = np.argsort(tri_z.mean(1))  # near-to-far helps early z rejects
    for f in order:
        if abs(areas[f]) < 1e-12 or x1[f] < x0[f] or y1[f] < y0[f]:
            continue
        xs = np.arange(x0[f], x1[f] + 1)
        ys = np.arange(y0[f], y1[f] + 1)
        gx, gy = np.meshgrid(xs + 0.5, ys + 0.5)
        a, b, c = tri[f]
        det = areas[f]
        w0 = ((b[0] - a[0]) * (gy - a[1]) - (gx - a[0]) * (b[1] - a[1])) / det
        w1 = ((gx - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (gy - a[1])) / det
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # Perspective-correct depth via interpolated 1/z.
        inv_z = w2 / tri_z[f, 0] + w1 / tri_z[f, 1] + w0 / tri_z[f, 2]
        zpix = 1.0 / np.maximum(inv_z, 1e-12)
        sub_d = depth[y0[f] : y1[f] + 1, x0[f] : x1[f] + 1]
        upd = inside & (zpix < sub_d)
        if not upd.any():
            continue
        sub_d[upd] = zpix[upd]
        sub_img = img[y0[f] : y1[f] + 1, x0[f] : x1[f] + 1]
        if vert_shade is None:
            sub_img[upd] = color * shade[f]
        else:
            # Gouraud: barycentric interpolation of the vertex shades
            # (w2 <-> vertex 0, w1 <-> vertex 1, w0 <-> vertex 2, matching
            # the depth interpolation above).
            vs = vert_shade[faces[f]]
            pix = w2 * vs[0] + w1 * vs[1] + w0 * vs[2]
            sub_img[upd] = color[None, :] * np.clip(pix[upd], 0, 1)[:, None]
        sub_mask = mask[y0[f] : y1[f] + 1, x0[f] : x1[f] + 1]
        sub_mask[upd] = True
    return img, mask


class SMPLRenderer:
    """Mesh overlay renderer with the reference's calling convention
    (ref src/util/renderer.py:23-115): ``renderer(verts, cam=[f, cx, cy],
    img=background)`` -> uint8 image; ``.rotated(verts, deg, axis=...)``
    renders the mesh rotated about its centroid."""

    def __init__(self, img_size: int = 256, flength: float = 500.0, faces=None,
                 face_path: Optional[str] = None, lighting: str = "directional"):
        if faces is None:
            if face_path is None:
                raise ValueError("need faces array or face_path (.npy)")
            faces = np.load(face_path)
        self.faces = np.asarray(faces, np.int64)
        self.h = self.w = img_size
        self.flength = flength
        self.lighting = lighting

    def __call__(
        self,
        verts,
        cam=None,
        img=None,
        do_alpha: bool = False,
        color_id: int = 0,
        img_size=None,
        ssaa: int = 1,
        lighting: Optional[str] = None,
    ) -> np.ndarray:
        """ssaa > 1 renders at ssaa x resolution and area-downsamples —
        the anti-aliasing role of OpenDR's MSAA 8 in the reference
        (ref src/util/renderer.py:157-254 num_samples); it is pure camera
        scaling, and its cost grows ~ssaa^2, so 2-3 is the useful range
        for logged images.

        lighting='points' switches to the reference's 3-point-light
        Gouraud model (slower numpy path, prettiest output);
        'directional' (default) is the flat-shaded path.
        """
        if img is not None:
            h, w = img.shape[:2]
            bg = np.asarray(img, np.float64)
            if bg.max() > 2.0:
                bg = bg / 255.0
        else:
            if img_size is not None:
                h, w = img_size[0], img_size[1]
            else:
                h, w = self.h, self.w
            bg = None
        if cam is None:
            cam = [self.flength, w / 2.0, h / 2.0]
        k = max(int(ssaa), 1)
        rh, rw = h * k, w * k
        rbg = bg
        if k > 1 and bg is not None:
            import cv2

            rbg = cv2.resize(bg, (rw, rh), interpolation=cv2.INTER_LINEAR)
        rendered, mask = rasterize_mesh(
            np.asarray(verts),
            self.faces,
            rh,
            rw,
            focal=float(cam[0]) * k,
            center=np.asarray(cam[1:3], np.float64) * k,
            color=MESH_COLORS[color_id % len(MESH_COLORS)],
            background=rbg,
            lighting=lighting if lighting is not None else self.lighting,
        )
        if k > 1:
            rendered = rendered.reshape(h, k, w, k, 3).mean(axis=(1, 3))
            mask = mask.reshape(h, k, w, k).mean(axis=(1, 3)) > 0.5
        out = np.clip(rendered, 0, 1)
        if do_alpha:
            out = np.concatenate([out, mask[..., None].astype(np.float64)], axis=-1)
        return (out * 255).astype(np.uint8)

    def rotated(self, verts, deg, cam=None, axis="y", img=None, do_alpha=False,
                color_id=0, img_size=None, ssaa: int = 1) -> np.ndarray:
        verts = np.asarray(verts)
        center = verts.mean(axis=0)
        new_v = (verts - center) @ _rot_mat(axis, deg) + center
        return self(new_v, cam=cam, img=img, do_alpha=do_alpha,
                    color_id=color_id, img_size=img_size, ssaa=ssaa)


def get_original(proc_param: Dict, verts, cam, joints, img_size=None):
    """Undo crop/scale preprocessing: recover a full-frame camera, shifted
    vertices, and original-image keypoints (ref renderer.py:260-283).

    proc_param: {'scale', 'start_pt', 'img_size'} as produced by
    utils/image.scale_and_crop.
    """
    img_size = proc_param["img_size"]
    undo_scale = 1.0 / np.array(proc_param["scale"])
    flength = 500.0

    cam_s, cam_pos = cam[0], cam[1:]
    tz = flength / (0.5 * img_size * cam_s)
    vert_shifted = np.asarray(verts) + np.hstack([cam_pos, tz])

    start_pt = np.asarray(proc_param["start_pt"]) - 0.5 * img_size
    principal = (np.array([img_size, img_size]) / 2.0 + start_pt) * undo_scale
    cam_for_render = np.hstack([flength * undo_scale, principal])

    margin = int(img_size / 2)
    kp_original = (np.asarray(joints) + proc_param["start_pt"] - margin) * undo_scale
    return cam_for_render, vert_shifted, kp_original


# --------------------------------------------------------------------------
# Skeleton drawing (ref draw_skeleton, renderer.py:286-447): same 19-joint
# cocoplus topology and left-light / right-dark color language.
# --------------------------------------------------------------------------

_PALETTE = {
    "pink": (197, 27, 125),
    "light_pink": (233, 163, 201),
    "light_green": (161, 215, 106),
    "green": (77, 146, 33),
    "red": (215, 48, 39),
    "light_red": (252, 146, 114),
    "light_orange": (252, 141, 89),
    "purple": (118, 42, 131),
    "light_purple": (175, 141, 195),
    "light_blue": (145, 191, 219),
    "blue": (69, 117, 180),
    "gray": (130, 130, 130),
    "white": (255, 255, 255),
}

# parent of each cocoplus joint (-1 = root-ish, no bone drawn)
_PARENTS_19 = (1, 2, 8, 9, 3, 4, 7, 8, 12, 12, 9, 10, 14, -1, 13, -1, -1, 15, 16)
_JOINT_COLORS_19 = (
    "light_pink", "light_pink", "light_pink", "pink", "pink", "pink",
    "light_blue", "light_blue", "light_blue", "blue", "blue", "blue",
    "purple", "purple", "red", "green", "green", "white", "white",
)
_BONE_COLORS_19 = {
    0: "light_pink", 1: "light_pink", 2: "light_pink", 3: "pink", 4: "pink",
    5: "pink", 6: "light_blue", 7: "light_blue", 8: "light_blue", 9: "blue",
    10: "blue", 11: "blue", 12: "purple", 14: "purple",
    17: "light_green", 18: "light_green",
}


def draw_skeleton(input_image, joints, draw_edges=True, vis=None, radius=None):
    """Draw the 19-joint (or any prefix) skeleton with per-limb colors.

    joints: (19, 2) or (2, 19) pixel coordinates.
    """
    import cv2

    image = np.asarray(input_image).copy()
    was_float = np.issubdtype(image.dtype, np.floating)
    scale01 = was_float and image.max() <= 2.0
    if was_float:
        image = (image * 255 if scale01 else image).astype(np.uint8)
    joints = np.asarray(joints)
    if joints.shape[0] == 2:
        joints = joints.T
    joints = np.round(joints).astype(int)
    k = joints.shape[0]
    if radius is None:
        radius = max(4, int(np.mean(image.shape[:2]) * 0.01))

    for j in range(k):
        if vis is not None and not vis[j]:
            continue
        pt = (int(joints[j, 0]), int(joints[j, 1]))
        col = _PALETTE[_JOINT_COLORS_19[j]]
        if draw_edges:
            cv2.circle(image, pt, radius, _PALETTE["white"], -1)
            cv2.circle(image, pt, radius - 1, col, -1)
            pa = _PARENTS_19[j] if j < len(_PARENTS_19) else -1
            if 0 <= pa < k and (vis is None or vis[pa]):
                pp = (int(joints[pa, 0]), int(joints[pa, 1]))
                cv2.circle(image, pp, radius - 1, _PALETTE[_JOINT_COLORS_19[pa]], -1)
                bone = _BONE_COLORS_19.get(j)
                if bone:
                    cv2.line(image, pt, pp, _PALETTE[bone], max(radius - 2, 1))
        else:
            cv2.circle(image, pt, radius - 1, col, 1)

    if was_float:
        image = image.astype(np.float32)
        if scale01:
            image /= 255.0
    return image


def draw_text(input_image, content: Dict) -> np.ndarray:
    """Render 'key: value' lines onto an image (ref renderer.py:450-474)."""
    import cv2

    image = np.asarray(input_image).copy()
    was_float = np.issubdtype(image.dtype, np.floating)
    if was_float:
        image = (image * 255).astype(np.uint8)
    y = 15
    for key in sorted(content):
        cv2.putText(image, f"{key}: {content[key]:.2g}", (5, y), 0, 0.45, (0, 0, 0))
        y += 15
    if was_float:
        image = image.astype(np.float32) / 255.0
    return image
