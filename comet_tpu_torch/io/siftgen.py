"""Offline SIFT-descriptor corpus generator.

Counterpart of comet_tpu/io/siftgen.py, numpy only: the same arrays from
the same seed. It computes REAL SIFT descriptors (the Lowe descriptor
pipeline: gradient sampling, dominant-orientation alignment,
Gaussian-weighted 4x4 spatial x 8 orientation trilinear binning, 0.2 clip,
renormalize, x512 uint8 quantization) over synthetic piecewise-flat 1/f
textures, so the descriptor statistics are SIFT's by construction; only
the images are synthetic.

Nearest-neighbor structure: real descriptor datasets are built from
features RE-OBSERVED across images (the same physical corner seen from
slightly different viewpoints). generate_with_queries models that: each
unique feature is observed 1..OBS_MAX times with position/rotation jitter
on a geometric scale ladder, and queries are held-out observations of
corpus features.

Matched by construction: value range and quantization (uint8, max <= 255),
energy (~512^2 a vector), sparsity from flat regions, per-subspace energy
correlation, and PQ codebook distortion. Not matched: the distance-to-rank
profile at the recall@100 boundary, which is more crowded than real
SIFT1M's, so recall measured on this corpus is a harder operating point
than SIFT1M, not a parity claim (tests/test_siftgen.py pins the
statistics).

Everything is vectorized numpy. Descriptor extraction follows Lowe (IJCV
2004) section 6; its constants (16x16 window, 0.2 clip, 512 scale) are the
standard published values.
"""

from __future__ import annotations

import numpy as np

WINDOW = 16          # descriptor sampling window (16x16 gradient samples)
CELLS = 4            # 4x4 spatial cells
ORI_BINS = 8         # orientation bins per cell
CLIP = 0.2           # Lowe's illumination clip
SCALE = 512.0        # float -> uint8 quantization scale
DIM = CELLS * CELLS * ORI_BINS  # 128

# calibrated re-observation structure (see module docstring): a fraction
# of features are one-off clutter; the rest are salient structure re-seen
# across many images, with per-observation viewpoint severity spanning a
# geometric ladder from near-identical to barely-related. The ladder is
# what produces the graded, steadily-growing neighbor-distance profile of
# real descriptor datasets (vs the crowded all-equidistant boundary of a
# pure Gaussian-mixture corpus that drives quantizer recall to the floor).
SOLO_FRAC = 0.3      # fraction of features observed exactly once
OBS_MIN = 32         # min observations of a recurring feature
OBS_MAX = 256        # max observations of a recurring feature
JITTER_LO = 0.3      # px, position-jitter scale of the closest view
JITTER_HI = 6.0      # px, position-jitter scale of the farthest view
ROT_PER_PX = 0.08    # rad of rotation jitter per px of position jitter


def _texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Natural-image-like texture: white noise shaped to a 1/f^beta
    amplitude spectrum (the canonical natural-image statistic), then
    posterized into piecewise-flat regions with step edges. The flat
    regions give the zero gradients (descriptor sparsity) and the edges
    the peaked orientation bins that characterize real SIFT; pure 1/f
    noise is dense texture everywhere and yields unrealistically uniform
    descriptors.

    The shaping parameters are drawn PER IMAGE — spectral slope beta
    (edge density: fine texture vs large flat shapes), spectral
    anisotropy (elongated vs isotropic structure), and posterize step
    (how much of the dynamic range survives quantization). Real photo
    collections span exactly these axes; holding them fixed collapses
    the descriptor manifold onto one content type and crowds the
    nearest-neighbor boundary far beyond real texmex data (measured:
    ~1.5k candidates within +-2 ADC sigma of the rank-100 boundary vs
    ~150 expected at SIFT1M's published PQ operating point)."""
    beta = rng.uniform(1.0, 1.9)
    aniso = np.exp(rng.uniform(-0.8, 0.8))
    qstep = rng.uniform(0.6, 1.7)
    noise = rng.normal(size=(size, size)).astype(np.float32)
    f = (np.fft.rfftfreq(size)[None, :] * aniso) ** 2 + (
        np.fft.fftfreq(size)[:, None] / aniso
    ) ** 2
    amp = 1.0 / np.sqrt(f + (1.0 / size) ** 2)
    img = np.fft.irfft2(np.fft.rfft2(noise) * amp ** beta, s=(size, size))
    img = img.astype(np.float32)
    img = (img - img.mean()) / (img.std() + 1e-9)
    # posterize -> flat regions + step edges
    img = np.floor(img / qstep)
    # soften edges over a couple of pixels ([1,2,1] twice, separable) so
    # gradients have finite support like anti-aliased/optical-blur edges
    for _ in range(2):
        img = (np.roll(img, 1, 0) + 2 * img + np.roll(img, -1, 0)) * 0.25
        img = (np.roll(img, 1, 1) + 2 * img + np.roll(img, -1, 1)) * 0.25
    return img.astype(np.float32)


def _spatial_weights() -> np.ndarray:
    """[WINDOW*WINDOW, CELLS*CELLS] bilinear spatial-bin weights, shared by
    every keypoint (the sampling grid is fixed relative to the window),
    with the Gaussian window (sigma = WINDOW/2) folded in."""
    ys, xs = np.mgrid[0:WINDOW, 0:WINDOW].astype(np.float32)
    ys = ys.ravel() + 0.5
    xs = xs.ravel() + 0.5
    c = WINDOW / 2.0
    g = np.exp(-(((ys - c) ** 2 + (xs - c) ** 2) / (2 * (0.5 * WINDOW) ** 2)))
    cy = ys * CELLS / WINDOW - 0.5
    cx = xs * CELLS / WINDOW - 0.5
    w = np.zeros((WINDOW * WINDOW, CELLS * CELLS), dtype=np.float32)
    y0 = np.floor(cy).astype(np.int64)
    x0 = np.floor(cx).astype(np.int64)
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            wy = 1.0 - np.abs(cy - yy)
            wx = 1.0 - np.abs(cx - xx)
            ok = (yy >= 0) & (yy < CELLS) & (xx >= 0) & (xx < CELLS)
            idx = np.where(ok, yy * CELLS + xx, 0)
            np.add.at(
                w,
                (np.arange(WINDOW * WINDOW), idx),
                np.where(ok, wy * wx * g, 0.0).astype(np.float32),
            )
    return w


_W_SPATIAL = _spatial_weights()  # [256, 16]

MAX_STRIDE = 8.0  # largest sampling stride (octave 2, top of the octave)

# rotation-, scale- and jitter-safe border: half-window at the largest
# stride under worst-case rotation (sqrt 2), plus jitter headroom
_MARGIN = int(WINDOW / 2 * MAX_STRIDE * 1.45) + 8


def _draw_strides(n: int, rng: np.random.Generator) -> np.ndarray:
    """Per-keypoint sampling stride (px between the 16x16 grid samples),
    modeling the SIFT scale pyramid: octave o holds 4x fewer detections
    than o-1 (area), continuous intra-octave scale. Multi-scale sampling
    is a first-order source of descriptor diversity in real corpora —
    the same scene yields entirely different descriptors per octave."""
    octave = rng.choice(3, size=n, p=np.array([16.0, 4.0, 1.0]) / 21.0)
    return (2.0 ** (octave + rng.uniform(0.0, 1.0, size=n))).astype(np.float32)


def _gradients(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    gy, gx = np.gradient(img)
    mag = np.sqrt(gx * gx + gy * gy).astype(np.float32)
    ori = np.arctan2(gy, gx).astype(np.float32)
    return mag, ori


def _pyramid(img: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """Gradient fields for octaves 0..2, full resolution. Octave o is the
    image blurred to sigma ~ 2^o (repeated separable [1,2,1], sigma^2
    accumulating 0.5 per pass) so sampling it at stride 2^o reads coarse
    structure instead of aliased fine detail — the standard scale-space
    construction, minus the downsampling (full-res keeps keypoint
    coordinates octave-independent)."""
    out = [_gradients(img)]
    cur = img
    for passes in (8, 24):  # cumulative sigma^2: 4 then 16
        for _ in range(passes):
            cur = (np.roll(cur, 1, 0) + 2 * cur + np.roll(cur, -1, 0)) * 0.25
            cur = (np.roll(cur, 1, 1) + 2 * cur + np.roll(cur, -1, 1)) * 0.25
        out.append(_gradients(cur))
    return out


def _select_anchors(
    mag_img: np.ndarray, n: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Keypoints importance-sampled by local gradient energy — a stand-in
    for a real interest-point detector (SIFT1M's descriptors sit on DoG
    extrema, i.e. ON structure, never in flat regions)."""
    h = mag_img.shape[0]
    energy = mag_img[_MARGIN : h - _MARGIN, _MARGIN : h - _MARGIN]
    p = (energy.ravel() ** 2).astype(np.float64)
    p /= p.sum()
    pick = rng.choice(p.size, size=n, p=p)
    side = h - 2 * _MARGIN
    ky = (pick // side + _MARGIN).astype(np.float32)
    kx = (pick % side + _MARGIN).astype(np.float32)
    ky += rng.uniform(-0.5, 0.5, size=n).astype(np.float32)
    kx += rng.uniform(-0.5, 0.5, size=n).astype(np.float32)
    return ky, kx


def _extract(
    mag_img: np.ndarray,
    ori_img: np.ndarray,
    ky: np.ndarray,
    kx: np.ndarray,
    dtheta: np.ndarray | None = None,
    stride: np.ndarray | None = None,
) -> np.ndarray:
    """[K, 128] descriptors at (ky, kx); dtheta adds per-keypoint rotation
    on top of the content-derived dominant orientation; stride scales the
    sampling grid per keypoint (the scale-pyramid octave)."""
    h = mag_img.shape[0]
    ys, xs = np.mgrid[0:WINDOW, 0:WINDOW].astype(np.float32)
    off_y = (ys.ravel() + 0.5 - WINDOW / 2)[None, :]  # [1, 256]
    off_x = (xs.ravel() + 0.5 - WINDOW / 2)[None, :]
    if stride is not None:
        off_y = off_y * stride[:, None]
        off_x = off_x * stride[:, None]

    # pass 1 — dominant orientation from the unrotated window
    # (gradient-energy-weighted circular mean: a cheap stand-in for
    # Lowe's 36-bin histogram peak that produces the same bin-0 energy
    # concentration in the final descriptors)
    iy = np.clip((ky[:, None] + off_y), 0, h - 1).astype(np.int64)
    ix = np.clip((kx[:, None] + off_x), 0, h - 1).astype(np.int64)
    m0 = mag_img[iy, ix]
    o0 = ori_img[iy, ix]
    theta = np.arctan2(
        (m0 * np.sin(o0)).sum(axis=1), (m0 * np.cos(o0)).sum(axis=1)
    ).astype(np.float32)  # [K]
    if dtheta is not None:
        theta = theta + dtheta

    # pass 2 — rotated sampling grid (nearest-pixel sampling; the Gaussian
    # window makes sub-pixel interpolation a second-order effect)
    ct, st = np.cos(theta)[:, None], np.sin(theta)[:, None]
    ry = ky[:, None] + off_x * st + off_y * ct
    rx = kx[:, None] + off_x * ct - off_y * st
    iy = np.clip(np.rint(ry), 0, h - 1).astype(np.int64)
    ix = np.clip(np.rint(rx), 0, h - 1).astype(np.int64)
    mag = mag_img[iy, ix]                      # [K, 256]
    ori = ori_img[iy, ix] - theta[:, None]     # rotation-relative

    # soft orientation binning into the 2 nearest of 8 bins
    ob = (ori / (2 * np.pi / ORI_BINS)) % ORI_BINS     # [K, 256] in [0, 8)
    b0 = np.floor(ob).astype(np.int64) % ORI_BINS
    b1 = (b0 + 1) % ORI_BINS
    w1 = (ob - np.floor(ob)).astype(np.float32)
    w0 = 1.0 - w1

    k_n, s_n = mag.shape
    contrib = np.zeros((k_n, s_n, ORI_BINS), dtype=np.float32)
    rows = np.arange(k_n)[:, None]
    cols = np.arange(s_n)[None, :]
    contrib[rows, cols, b0] = mag * w0
    contrib[rows, cols, b1] += mag * w1

    # spatial binning: one batched matmul over the shared weight table
    # [K, 8, 256] @ [256, 16] -> [K, 8, 16]
    desc = np.matmul(contrib.transpose(0, 2, 1), _W_SPATIAL)
    desc = desc.transpose(0, 2, 1).reshape(k_n, DIM)

    # Lowe normalization: unit norm, clip 0.2, renormalize, x512 uint8
    norm = np.linalg.norm(desc, axis=1, keepdims=True)
    desc /= np.maximum(norm, 1e-9)
    np.clip(desc, 0.0, CLIP, out=desc)
    norm = np.linalg.norm(desc, axis=1, keepdims=True)
    desc /= np.maximum(norm, 1e-9)
    return np.clip(np.rint(desc * SCALE), 0, 255).astype(np.float32)


def _obs_counts(n_anchors: int, rng: np.random.Generator) -> np.ndarray:
    """Observation count per unique feature: SOLO_FRAC one-off clutter,
    the rest salient structure re-seen OBS_MIN..OBS_MAX times."""
    c = rng.integers(OBS_MIN, OBS_MAX + 1, size=n_anchors)
    c[rng.random(n_anchors) < SOLO_FRAC] = 1
    return c


def generate(
    n: int,
    seed: int = 0,
    image_size: int = 512,
    keypoints_per_image: int = 4096,
) -> np.ndarray:
    """[n, 128] float32 single-observation descriptors (uint8-valued,
    like texmex data). No re-observation structure — use
    generate_with_queries for recall benchmarks."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, DIM), dtype=np.float32)
    done = 0
    while done < n:
        levels = _pyramid(_texture(rng, image_size))
        take = min(keypoints_per_image, n - done)
        strides = _draw_strides(take, rng)
        octave = np.minimum(np.log2(strides).astype(np.int64), 2)
        for o in range(3):
            sel = np.flatnonzero(octave == o)
            if sel.size == 0:
                continue
            mag, ori = levels[o]
            ky, kx = _select_anchors(mag, sel.size, rng)
            out[done + sel] = _extract(mag, ori, ky, kx, stride=strides[sel])
        done += take
    return out


def _extract_views(
    levels: list[tuple[np.ndarray, np.ndarray]],
    aky: np.ndarray,
    akx: np.ndarray,
    strides: np.ndarray,
    octave: np.ndarray,
    rep: np.ndarray,
    scale: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Extract one observation per entry of `rep` (feature index): the
    feature's anchor jittered by `scale` px in a random direction, with
    rotation jitter proportional to the jitter in GRID units (a 1-px shift
    of a coarse stride-8 feature is 1/8 of a sample — viewpoint change
    scales with the feature, not the pixel grid)."""
    ang = rng.uniform(0, 2 * np.pi, rep.size).astype(np.float32)
    st = strides[rep]
    ky = aky[rep] + scale * np.cos(ang)
    kx = akx[rep] + scale * np.sin(ang)
    dth = (scale / st * ROT_PER_PX * rng.normal(size=rep.size)).astype(np.float32)
    out = np.empty((rep.size, DIM), dtype=np.float32)
    oc = octave[rep]
    for o in range(len(levels)):
        sel = np.flatnonzero(oc == o)
        if sel.size:
            mag, ori = levels[o]
            out[sel] = _extract(
                mag, ori, ky[sel], kx[sel], dtheta=dth[sel], stride=st[sel]
            )
    return out


def generate_with_queries(
    n: int,
    n_queries: int,
    seed: int = 0,
    image_size: int = 512,
    anchors_per_image: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """(base [n, 128], queries [nq, 128]) with texmex-like neighbor
    structure: unique multi-scale features observed 1..OBS_MAX times in
    the base at geometric jitter-scale ladders, queries = held-out
    close-range observations of recurring corpus features, picked
    proportionally to observation count (the texmex query set is the same
    features seen in other images, so high-recurrence structure is
    overrepresented among queries).

    Each image contributes only anchors_per_image unique features
    (~26k observations), so a 1M-descriptor corpus draws on ~40 distinct
    texture processes — background diversity matching real photo
    collections is exactly what keeps the rank-100 boundary sparse.
    Jitter is measured in px ON THE FEATURE'S OCTAVE (scaled by its
    sampling stride): viewpoint change is relative to the feature's own
    scale."""
    rng = np.random.default_rng(seed)
    base = np.empty((n, DIM), dtype=np.float32)
    queries = np.empty((n_queries, DIM), dtype=np.float32)
    nb = nq = 0

    log_ratio = np.log(JITTER_HI / JITTER_LO)
    while nb < n or nq < n_queries:
        levels = _pyramid(_texture(rng, image_size))
        strides = _draw_strides(anchors_per_image, rng)
        octave = np.minimum(np.log2(strides).astype(np.int64), 2)
        counts = _obs_counts(anchors_per_image, rng)
        aky = np.empty(anchors_per_image, dtype=np.float32)
        akx = np.empty(anchors_per_image, dtype=np.float32)
        for o in range(3):
            sel = np.flatnonzero(octave == o)
            if sel.size:
                ky, kx = _select_anchors(levels[o][0], sel.size, rng)
                aky[sel], akx[sel] = ky, kx

        # base observations: each feature's views sit on a geometric
        # jitter-scale ladder from JITTER_LO (near-identical) to JITTER_HI
        # (barely related) — view j of c gets scale lo*(hi/lo)^(j/(c-1)),
        # in units of the feature's stride
        if nb < n:
            rep = np.repeat(np.arange(anchors_per_image), counts)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            j = np.arange(rep.size) - np.repeat(starts, counts)
            frac = j / np.maximum(np.repeat(counts, counts) - 1, 1)
            scale = (
                JITTER_LO * np.exp(frac * log_ratio) * strides[rep]
            ).astype(np.float32)
            take_n = min(rep.size, n - nb)
            rep, scale = rep[:take_n], scale[:take_n]
            base[nb : nb + rep.size] = _extract_views(
                levels, aky, akx, strides, octave, rep, scale, rng
            )
            nb += rep.size

        # query observations: one extra close-range view of a recurring
        # feature (texmex queries are features that DO have matches),
        # chosen proportionally to observation count
        if nq < n_queries:
            take = min(max(1, anchors_per_image // 16), n_queries - nq)
            multi = np.flatnonzero(counts > 1)
            p = counts[multi].astype(np.float64)
            sel = rng.choice(multi, size=take, replace=False, p=p / p.sum())
            qscale = (
                rng.uniform(JITTER_LO, 1.0, take) * strides[sel]
            ).astype(np.float32)
            queries[nq : nq + take] = _extract_views(
                levels, aky, akx, strides, octave, sel, qscale, rng
            )
            nq += take
    return base, queries


def generate_queries(n: int, seed: int = 10_000, **kw) -> np.ndarray:
    """Query descriptors from *different* images, no match structure
    (use generate_with_queries for texmex-like benchmarks)."""
    return generate(n, seed=seed, **kw)
