"""Debug visualisations mirroring the reference's image dumps.

Covers SuperpixelSegmentation::getSegmentedImage / getRandomColorImage
(SuperpixelSegmentation.cpp:53-120), NormalAdaptiveSuperpixel::getNormalImg
(NormalAdaptiveSuperpixel.cpp:39-55), NormalMapGenerator::getNormalImg
(NormalMapGenerator.cu:423-440), and MarkovRandomField's depth colouring
(MarkovRandomField.cpp getRGB:86-99).  All jittable; returns u8 arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_color_labels(labels: jnp.ndarray, k: int, seed: int = 0) -> jnp.ndarray:
    """Per-label random colours; -1 labels are black (getRandomColorImage)."""
    rng = np.random.default_rng(seed)
    palette = jnp.asarray(rng.integers(0, 255, (k, 3), dtype=np.uint8))
    lab0 = jnp.maximum(labels, 0)
    img = jnp.take(palette, lab0, axis=0)
    return jnp.where((labels >= 0)[..., None], img, 0).astype(jnp.uint8)


def label_boundaries(color: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """White superpixel boundaries over the colour image
    (getSegmentedImage 'Line' mode, SuperpixelSegmentation.cpp:57-73)."""
    down = jnp.concatenate([labels[1:, :], labels[-1:, :]], axis=0)
    right = jnp.concatenate([labels[:, 1:], labels[:, -1:]], axis=1)
    edge = (labels != down) | (labels != right)
    return jnp.where(edge[..., None], 255, color).astype(jnp.uint8)


def normal_image(normals: jnp.ndarray) -> jnp.ndarray:
    """n -> u8 rgb via 255*(n+1)/2 (getNormalImg)."""
    return jnp.clip(255.0 * (normals + 1.0) / 2.0, 0, 255).astype(jnp.uint8)


def depth_rgb(depth: jnp.ndarray, scale: float = 5000.0) -> jnp.ndarray:
    """The reference's ratio-based BGR ramp (MarkovRandomField::getRGB):
    valid depth maps through a 3-segment ramp, invalid (<=50mm) is black."""
    ratio = jnp.minimum(depth / scale, 0.99)
    c0 = jnp.where(
        ratio < 0.33, ratio / 0.33 * 255.0,
        jnp.where(ratio < 0.66, (0.66 - ratio) / 0.33 * 255.0, 0.0),
    )
    c1 = jnp.where(
        ratio < 0.33, 0.0,
        jnp.where(ratio < 0.66, (ratio - 0.33) / 0.33 * 255.0,
                  (0.99 - ratio) / 0.33 * 255.0),
    )
    c2 = jnp.where(ratio < 0.66, 0.0, (ratio - 0.66) / 0.33 * 255.0)
    img = jnp.stack([c0, c1, c2], axis=-1)
    valid = depth > 50.0
    return jnp.where(valid[..., None], jnp.clip(img, 0, 255), 0.0).astype(jnp.uint8)


def depth_histogram_image(
    depth: jnp.ndarray, max_depth_mm: int = 10000
) -> jnp.ndarray:
    """Histogram-equalised depth render (Kinect::CreateDepthImage,
    Kinect/Kinect.cpp:108-151 — the NiSimpleViewer algorithm).

    The cumulative histogram over integer-mm depth maps each valid pixel to
    `256*(1 - cdf(z))` in the G and R channels of the BGR image (blue stays
    0 — cv::Vec3b(0, v, v) — so near is yellow, far black); z==0 stays at
    bin 0's value like the reference (whose final loop does not re-test
    validity).  Jittable.
    """
    z = jnp.clip(depth.astype(jnp.int32), 0, max_depth_mm - 1)
    valid = z > 0
    hist = jnp.zeros((max_depth_mm,), jnp.float32).at[
        jnp.where(valid, z, 0)
    ].add(valid.astype(jnp.float32))
    cdf = jnp.cumsum(hist)
    points = jnp.maximum(cdf[-1], 1.0)
    ramp = 256.0 * (1.0 - cdf / points)
    ramp = ramp.at[0].set(0.0)  # depth_hist[0] is never rescaled (stays 0)
    val = jnp.clip(ramp[z], 0, 255).astype(jnp.uint8)
    zero = jnp.zeros_like(val)
    return jnp.stack([zero, val, val], axis=-1)  # (B, G, R) like cv::Vec3b


def point_cloud(
    points_mm: jnp.ndarray,
    color: jnp.ndarray | None = None,
    *,
    max_depth_mm: float = 15000.0,
    flip_z: bool = False,
) -> np.ndarray:
    """Flatten a [H, W, 3] point map (mm) to an [N, 6] xyzrgb array in
    metres, keeping points with 50 < z < max_depth_mm — the reference's PCL
    cloud construction (main.cpp:234-301: both near and far culls).  The
    reference also stores z NEGATED (point.z = -z/1000, a PCL camera-frame
    convention); pass flip_z=True for that exact convention — the default
    keeps +z forward, which most PLY viewers expect."""
    pts = np.asarray(points_mm, np.float32).reshape(-1, 3)
    ok = (pts[:, 2] > 50.0) & (pts[:, 2] < max_depth_mm)
    xyz = pts[ok] / 1000.0
    if flip_z:
        xyz = xyz * np.array([1.0, 1.0, -1.0], np.float32)
    if color is None:
        rgb = np.full_like(xyz, 255.0)
    else:
        rgb = np.asarray(color, np.float32).reshape(-1, 3)[ok]
    return np.concatenate([xyz, rgb], axis=-1)


def save_ply(path: str, cloud: np.ndarray) -> None:
    """Write an [N, 6] xyzrgb cloud as ASCII PLY — the host-side analog of
    the reference's PCL 6-viewport visualisation / pcd dumps
    (main.cpp:362-413, Kinect.cpp SavePointcloud)."""
    n = cloud.shape[0]
    header = "\n".join(
        [
            "ply",
            "format ascii 1.0",
            f"element vertex {n}",
            "property float x",
            "property float y",
            "property float z",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "end_header",
        ]
    )
    body = "\n".join(
        f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
        f"{int(p[3])} {int(p[4])} {int(p[5])}"
        for p in cloud
    )
    with open(path, "w") as f:
        f.write(header + "\n" + body + "\n")


def save_png(path: str, image: jnp.ndarray) -> None:
    """Write a u8 image (mirrors the reference's cv::imwrite debug hooks)."""
    from PIL import Image

    Image.fromarray(np.asarray(image)).save(path)


def save_video(path: str, frames, fps: float = 30.0) -> None:
    """Write a frame sequence as an animated GIF — the analog of the
    reference's per-run segmentation cv::VideoWriter
    (SuperpixelSegmentation.cpp:9, 30 fps XVID).  `frames` is an iterable of
    u8 [H, W, 3] arrays; GIF is the codec-free container PIL can always
    write (path should end in .gif)."""
    from PIL import Image

    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    if not imgs:
        raise ValueError("no frames")
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(round(1000.0 / fps)),
        loop=0,
    )


def comparison_figure(panels, cols: int = 3, caption_h: int = 18) -> np.ndarray:
    """Side-by-side montage of captioned depth renders — the reference's PCL
    6-viewport comparison (INPUT / GROUND TRUTH / MRF / RGBF / JBF / PROPOSED,
    main.cpp:362-413) as one PNG.

    panels: ordered dict/list of (name, u8 [H, W, 3] image); returns the
    montage u8 array (rows of `cols` panels, each with a caption bar)."""
    from PIL import Image, ImageDraw

    items = list(panels.items()) if isinstance(panels, dict) else list(panels)
    if not items:
        raise ValueError("no panels")
    h, w = items[0][1].shape[:2]
    rows = -(-len(items) // cols)
    out = np.zeros((rows * (h + caption_h), cols * w, 3), np.uint8)
    for i, (name, img) in enumerate(items):
        r, c = divmod(i, cols)
        y0 = r * (h + caption_h)
        bar = Image.new("RGB", (w, caption_h), (30, 30, 30))
        ImageDraw.Draw(bar).text((4, 2), str(name), fill=(255, 255, 255))
        out[y0 : y0 + caption_h, c * w : (c + 1) * w] = np.asarray(bar)
        out[y0 + caption_h : y0 + caption_h + h, c * w : (c + 1) * w] = (
            np.asarray(img, np.uint8)
        )
    return out


def dump_kde_debug(out_dir: str, res, color, k: int, frame_id: int = 0) -> list:
    """Per-frame debug dumps mirroring the reference's always-on
    cv::imwrite("segmentation.jpg"/"labelImage.jpg") hooks
    (KinectDepthEnhancement.cpp:69,77) — here behind an explicit flag, plus
    the normal and refined-depth renders.  `res` is a KDEResult; returns the
    written paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{frame_id:06d}")
    paths = []

    seg = label_boundaries(color, res.nasp_labels)
    save_png(base + "_segmentation.png", seg)
    paths.append(base + "_segmentation.png")

    lab = random_color_labels(res.merged_labels, k)
    save_png(base + "_labelImage.png", lab)
    paths.append(base + "_labelImage.png")

    save_png(base + "_normals.png", normal_image(res.normals))
    paths.append(base + "_normals.png")

    save_png(base + "_depth.png", depth_rgb(res.optimized_points[..., 2]))
    paths.append(base + "_depth.png")
    return paths
