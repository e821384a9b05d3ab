"""Feature detection + SIFT-style descriptors, fully jitted.

Replacement for FeatureProc.{h,cpp}, which shells out to the
prebuilt SiftGPU OpenGL library (DetectFeatureSingleView,
FeatureProc.cpp:14-75). Here detection and description are batched JAX ops:

  - scale space: separable Gaussian pyramid (static octave/scale counts)
  - detector: multi-scale Harris corner response, 3x3 NMS via max-pool
    equality, margin bands zeroed exactly like the reference's pre-blanking
    (FeatureProc.cpp:28-43 -> filters.margin_mask)
  - fixed-capacity top-K keypoints across all levels (static shapes)
  - descriptors: 4x4x8 gradient-orientation histograms over a 16x16 patch
    resampled at the keypoint's scale and dominant orientation (the SIFT
    layout SiftGPU produces), L2-normalized with 0.2 clipping

The matmul matcher lives in ops/match.py. Keypoint capacity K and
pyramid shape are static; validity masks carry the dynamic counts.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    uv: jnp.ndarray        # [K,2] float32 source-image pixel coords
    scale: jnp.ndarray     # [K] float32 (pyramid sampling step)
    angle: jnp.ndarray     # [K] float32 dominant orientation (rad)
    score: jnp.ndarray     # [K] float32 detector response
    valid: jnp.ndarray     # [K] bool
    desc: jnp.ndarray      # [K,128] float32 L2-normalized descriptors


def _gauss_kernel1d(sigma: float, radius: int):
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: jnp.ndarray, sigma: float, radius: int | None = None):
    """Separable Gaussian blur of [H,W] (edge-replicate padding)."""
    radius = radius or max(1, int(3.0 * sigma + 0.5))
    k = _gauss_kernel1d(sigma, radius)
    pad = [(radius, radius)]
    x = jnp.pad(img, pad + [(0, 0)], mode="edge")
    x = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"),
                 in_axes=1, out_axes=1)(x)
    x = jnp.pad(x, [(0, 0)] + pad, mode="edge")
    x = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(x)
    return x


def _downsample2(img):
    return img[::2, ::2]


def _harris(img: jnp.ndarray, k: float = 0.04, sigma: float = 1.5):
    """Harris corner response of [H,W]."""
    dx = (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)) * 0.5
    dy = (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)) * 0.5
    a = gaussian_blur(dx * dx, sigma)
    b = gaussian_blur(dy * dy, sigma)
    c = gaussian_blur(dx * dy, sigma)
    det = a * b - c * c
    tr = a + b
    return det - k * tr * tr


def _nms3(r: jnp.ndarray):
    """True where r equals the 3x3 neighborhood max."""
    neg = -jnp.inf
    m = r
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            if sy == 0 and sx == 0:
                continue
            sh = jnp.roll(jnp.roll(r, sy, 0), sx, 1)
            m = jnp.maximum(m, sh)
    return r >= m


def _grad_level(scale, num_grad_levels: int):
    """Gradient-pyramid level whose smoothing matches the keypoint scale
    (half-octave steps: sigma_l = 1.6 * 2^(l/2))."""
    l = jnp.round(2.0 * jnp.log2(jnp.maximum(scale, 1e-6)))
    return jnp.clip(l.astype(jnp.int32), 0, num_grad_levels - 1)


def _grad_pyramid(img: jnp.ndarray, num_octaves: int):
    """Octave-downsampled Gaussian gradient atlas.

    Levels l = 2o+j carry total smoothing sigma_l = 1.6 * 2^(l/2) but live
    at octave o's resolution (downsample 2^o), exactly the recursive SIFT
    pyramid, so a keypoint's sample spacing in LEVEL pixels is bounded by
    ~2.83 regardless of its scale.

    Returns (gx_atlas [R,W], gy_atlas [R,W], meta) where the atlases stack
    all levels' rows (level o rows at width W>>o, zero-padded to W) and
    meta = (row_offsets, heights, widths, downsample factors) as static
    tuples.
    """
    sigma0 = 1.6
    g = gaussian_blur(img, sigma0)
    Wp = img.shape[1]
    gx_rows, gy_rows = [], []
    offs, hs, ws, dss = [], [], [], []
    off = 0
    for o in range(num_octaves):
        s2 = sigma0 * 2.0 ** 0.5
        g2 = gaussian_blur(g, float((s2 * s2 - sigma0 * sigma0) ** 0.5))
        for gl in (g, g2):
            gx = (jnp.roll(gl, -1, 1) - jnp.roll(gl, 1, 1)) * 0.5
            gy = (jnp.roll(gl, -1, 0) - jnp.roll(gl, 1, 0)) * 0.5
            h, w = gl.shape
            gx_rows.append(jnp.pad(gx, ((0, 0), (0, Wp - w))))
            gy_rows.append(jnp.pad(gy, ((0, 0), (0, Wp - w))))
            offs.append(off)
            hs.append(h)
            ws.append(w)
            dss.append(2 ** o)
            off += h
        if o + 1 < num_octaves:
            s4 = sigma0 * 2.0
            g4 = gaussian_blur(g2, float((s4 * s4 - s2 * s2) ** 0.5))
            g = _downsample2(g4)   # local sigma back to 1.6
    gx_atlas = jnp.concatenate(gx_rows)
    gy_atlas = jnp.concatenate(gy_rows)
    meta = (tuple(offs), tuple(hs), tuple(ws), tuple(dss))
    return gx_atlas, gy_atlas, meta


def _sample_grad_patches(gx_atlas, gy_atlas, meta, lvl, uv, dx, dy):
    """Batched exact 4-tap bilinear gradient sampling.

    lvl [K] int32 pyramid level per keypoint; uv [K,2] full-res center;
    dx/dy [K,S] sample offsets in LEVEL pixels. Returns (gx, gy) [K,S].
    Samples beyond the level image edge clamp to the edge pixel
    (replicate-edge)."""
    offs = jnp.asarray(meta[0], jnp.int32)[lvl][:, None]   # [K,1]
    Hl = jnp.asarray(meta[1], jnp.int32)[lvl][:, None]
    Wl = jnp.asarray(meta[2], jnp.int32)[lvl][:, None]
    ds = jnp.asarray(meta[3], jnp.float32)[lvl]
    sx = (uv[:, 0] / ds)[:, None] + dx
    sy = (uv[:, 1] / ds)[:, None] + dy
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, Wl - 2)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, Hl - 2)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    r0 = offs + y0

    def tap(atlas):
        return ((atlas[r0, x0] * (1 - fx) + atlas[r0, x0 + 1] * fx) *
                (1 - fy) +
                (atlas[r0 + 1, x0] * (1 - fx) + atlas[r0 + 1, x0 + 1] * fx) *
                fy)

    return tap(gx_atlas), tap(gy_atlas)


def _orientation_batch(atlases, meta, lvl, uv, scale, radius: int = 8):
    """Dominant gradient orientations for ALL keypoints at once (36-bin
    Gaussian-weighted histograms, like SIFT). The window is SCALE-ADAPTIVE:
    gradients are sampled on a grid spaced by the keypoint's scale, from
    the pyramid level whose smoothing matches that scale (sampling the raw
    image instead — round-1 behavior — biased gradient directions toward
    the pixel axes and capped recall at ~0.63). Histogram binning is a
    masked [K,S,36] reduction instead of per-sample scatter-adds. Returns
    (angle1 [K], angle2 [K], ratio2 [K])."""
    d = jnp.arange(-radius, radius, dtype=jnp.float32) + 0.5
    dyg, dxg = jnp.meshgrid(d, d, indexing="ij")
    dxg = dxg.ravel()[None]                                 # [1,S]
    dyg = dyg.ravel()[None]
    ds = jnp.asarray(meta[3], jnp.float32)[lvl]
    spacing = (scale / ds)[:, None]                         # [K,1] level px
    gx, gy = _sample_grad_patches(*atlases, meta, lvl, uv,
                                  spacing * dxg, spacing * dyg)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx)
    wgt = jnp.exp(-0.5 * ((dxg ** 2 + dyg ** 2) / (radius * radius / 2.25)))
    # soft-bin into the two nearest of 36 bins (linear split)
    pos = (ang + jnp.pi) / (2 * jnp.pi) * 36.0 - 0.5
    b0 = jnp.floor(pos)
    f = pos - b0
    b0i = b0.astype(jnp.int32) % 36
    b1i = (b0i + 1) % 36
    contrib = mag * wgt
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 36), 2)
    Wb = (jnp.where(bins == b0i[..., None],
                    (contrib * (1 - f))[..., None], 0.0) +
          jnp.where(bins == b1i[..., None],
                    (contrib * f)[..., None], 0.0))
    hist = Wb.sum(1)                                        # [K,36]
    # smooth circularly (Lowe smooths several times; one pass left ~1/3 of
    # repeated keypoints picking a different peak under rotation)
    for _ in range(4):
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0

    def take(h, idx):
        return jnp.take_along_axis(h, (idx % 36)[:, None], axis=-1)[:, 0]

    def refine(peak):
        hl = take(hist, peak - 1)
        hc = take(hist, peak)
        hr = take(hist, peak + 1)
        den = hl - 2 * hc + hr
        off = jnp.where(jnp.abs(den) < 1e-12, 0.0,
                        jnp.clip(0.5 * (hl - hr) / den, -0.5, 0.5))
        return ((peak.astype(jnp.float32) + 0.5 + off) / 36.0 *
                2 * jnp.pi - jnp.pi)

    peak = jnp.argmax(hist, -1)                             # [K]
    # second peak (local max outside +-1 bin of the first), SIFT-style:
    # a rival peak >= 0.8*max makes orientation ambiguous; the caller may
    # emit a duplicate keypoint at angle2
    allbins = jnp.arange(36)[None]
    near = jnp.minimum((allbins - peak[:, None]) % 36,
                       (peak[:, None] - allbins) % 36) <= 1
    is_lmax = ((hist >= jnp.roll(hist, 1, -1)) &
               (hist >= jnp.roll(hist, -1, -1)))
    h2 = jnp.where(near | ~is_lmax, -jnp.inf, hist)
    peak2 = jnp.argmax(h2, -1)
    h2p = take(h2, peak2)
    ratio2 = jnp.where(jnp.isfinite(h2p),
                       h2p / jnp.maximum(take(hist, peak), 1e-12), 0.0)
    return refine(peak), refine(peak2), ratio2


def _descriptor_batch(atlases, meta, lvl, uv, scale, angle):
    """128-d SIFT-layout descriptors for ALL keypoints at once.

    Same math as the former per-keypoint _descriptor (trilinear soft
    binning over 4x4 spatial cells x 8 orientation bins, scale-matched
    gradient field, MAGNIF=0.75 measured best on the recall harness) but
    the sampling is batched (_sample_grad_patches) and the trilinear
    binning is a separable pair of weight tensors contracted with one
    batched einsum instead of per-sample scatter-adds."""
    MAGNIF = 0.75
    g = (jnp.arange(16, dtype=jnp.float32) - 7.5)
    gyg, gxg = jnp.meshgrid(g, g, indexing="ij")
    gxg = gxg.ravel()[None]                                 # [1,S]
    gyg = gyg.ravel()[None]
    ca, sa = jnp.cos(angle)[:, None], jnp.sin(angle)[:, None]   # [K,1]
    ds = jnp.asarray(meta[3], jnp.float32)[lvl]
    spac = (MAGNIF * scale / ds)[:, None]
    dx = spac * (ca * gxg - sa * gyg)
    dy = spac * (sa * gxg + ca * gyg)
    gxi, gyi = _sample_grad_patches(*atlases, meta, lvl, uv, dx, dy)
    # rotate gradients into the keypoint frame
    gxv = ca * gxi + sa * gyi
    gyv = -sa * gxi + ca * gyi
    mag = jnp.sqrt(gxv * gxv + gyv * gyv)
    ang = jnp.arctan2(gyv, gxv)

    wgt = jnp.exp(-0.5 * ((gxg ** 2 + gyg ** 2) / 64.0))    # [1,S]
    contrib = mag * wgt                                     # [K,S]

    # orientation soft binning -> O [K,S,8] (two nonzero weights per row)
    opos = (ang + jnp.pi) / (2 * jnp.pi) * 8.0 - 0.5
    ob0 = jnp.floor(opos)
    of = opos - ob0
    ob0 = ob0.astype(jnp.int32) % 8
    ob1 = (ob0 + 1) % 8
    obins = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 8), 2)
    O = (jnp.where(obins == ob0[..., None], (contrib * (1 - of))[..., None],
                   0.0) +
         jnp.where(obins == ob1[..., None], (contrib * of)[..., None], 0.0))

    # spatial bilinear cell weights -> Wsp [K,S,16] (<=4 nonzeros per row;
    # cells outside 0..3 simply match no bin — the boundary zeroing)
    cxpos = (gxg + 6.0) / 4.0                               # [1,S]
    cypos = (gyg + 6.0) / 4.0
    cx0 = jnp.floor(cxpos)
    cy0 = jnp.floor(cypos)
    fx = cxpos - cx0
    fy = cypos - cy0
    cx0 = cx0.astype(jnp.int32)
    cy0 = cy0.astype(jnp.int32)
    cbins = jnp.arange(4)[None, None]                       # [1,1,4]
    W4x = (jnp.where(cbins == cx0[..., None], (1.0 - fx)[..., None], 0.0) +
           jnp.where(cbins == cx0[..., None] + 1, fx[..., None], 0.0))
    W4y = (jnp.where(cbins == cy0[..., None], (1.0 - fy)[..., None], 0.0) +
           jnp.where(cbins == cy0[..., None] + 1, fy[..., None], 0.0))
    Wsp = (W4y[..., :, None] * W4x[..., None, :]).reshape(
        1, W4x.shape[1], 16)                                # [1,S,16]

    # desc[k, cell*8+ob] = sum_s Wsp[s,cell] * O[k,s,ob]
    hi = jax.lax.Precision.HIGHEST
    desc = jnp.einsum("zsc,kso->kco", Wsp, O, precision=hi).reshape(
        -1, 128)
    n = jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-8)
    desc = jnp.minimum(desc / n, 0.2)
    return desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True),
                              1e-8)


def _dog_extrema(dogs, contrast_thresh: float, edge_ratio: float = 10.0):
    """Scale-space extrema of a DoG stack [S,H,W]: 26-neighborhood max/min
    on the middle scales, contrast threshold, and 2x2 Hessian edge
    rejection (the SIFT detector's acceptance rules; the reference gets
    these from SiftGPU, FeatureProc.cpp:20)."""
    S = dogs.shape[0]

    # separable 3x3 neighborhood max/min per level (8 elementwise passes
    # per scale instead of 52+ for an explicit 26-shift loop)
    def max3(a, ax):
        return jnp.maximum(a, jnp.maximum(jnp.roll(a, 1, ax),
                                          jnp.roll(a, -1, ax)))

    def min3(a, ax):
        return jnp.minimum(a, jnp.minimum(jnp.roll(a, 1, ax),
                                          jnp.roll(a, -1, ax)))

    mx9 = [max3(max3(dogs[s], 0), 1) for s in range(S)]   # 3x3 incl self
    mn9 = [min3(min3(dogs[s], 0), 1) for s in range(S)]

    resp = []
    for s in range(1, S - 1):
        d = dogs[s]
        # 27-neighborhood max/min INCLUDING the center: d is an extremum
        # iff it EQUALS the neighborhood extreme. Exact ties on a DoG
        # plateau admit the whole plateau where the strict 26-exclusive
        # test admitted none — measure-zero on real float data, and the
        # recall gates (tests/test_feature_recall.py) pin the behavior.
        mx = jnp.maximum(mx9[s], jnp.maximum(mx9[s - 1], mx9[s + 1]))
        mn = jnp.minimum(mn9[s], jnp.minimum(mn9[s - 1], mn9[s + 1]))
        is_ext = ((d >= mx) & (d > contrast_thresh)) | \
                 ((d <= mn) & (d < -contrast_thresh))

        # edge rejection via the spatial Hessian trace^2/det ratio
        dxx = jnp.roll(d, -1, 1) + jnp.roll(d, 1, 1) - 2 * d
        dyy = jnp.roll(d, -1, 0) + jnp.roll(d, 1, 0) - 2 * d
        dxy = (jnp.roll(jnp.roll(d, -1, 0), -1, 1) -
               jnp.roll(jnp.roll(d, -1, 0), 1, 1) -
               jnp.roll(jnp.roll(d, 1, 0), -1, 1) +
               jnp.roll(jnp.roll(d, 1, 0), 1, 1)) * 0.25
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r1 = (edge_ratio + 1.0) ** 2 / edge_ratio
        not_edge = (det > 0) & (tr * tr < r1 * det)
        resp.append(jnp.where(is_ext & not_edge, jnp.abs(d), -jnp.inf))
    return jnp.stack(resp)            # [S-2,H,W]


@partial(jax.jit, static_argnames=("max_keypoints", "num_levels", "margins",
                                   "detector", "scales_per_octave"))
def detect_and_describe(
    gray: jnp.ndarray,            # [H,W] float32 (any consistent scale)
    *,
    max_keypoints: int = 512,
    num_levels: int = 3,
    margins: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    min_score: float = 1e-7,
    detector: str = "dog",
    scales_per_octave: int = 3,
) -> Keypoints:
    """Detect up to K keypoints and compute SIFT-layout descriptors.

    detector="dog" (default): difference-of-Gaussians scale-space extrema
    with contrast + edge rejection — the detector SiftGPU implements.
    detector="harris": the original multi-scale corner stopgap.
    margins = (hl, hr, vl, vr) ratios (FeatureProc.cpp:28-43)."""
    from .filters import margin_mask

    h, w = gray.shape
    img = gray.astype(jnp.float32)
    img = img / jnp.maximum(jnp.max(jnp.abs(img)), 1e-8)

    hl, hr, vl, vr = margins
    all_uv, all_score, all_scale = [], [], []

    if detector == "dog":
        sigma0 = 1.6
        k = 2.0 ** (1.0 / scales_per_octave)
        base = gaussian_blur(img, sigma0)
        for octave in range(num_levels):
            oh, ow = base.shape
            # gaussian stack for this octave
            gs = [base]
            sig = sigma0
            for s in range(scales_per_octave + 2):
                # incremental blur so level s has total sigma sigma0 * k^s
                gs.append(gaussian_blur(gs[-1],
                                        float(sig * (k * k - 1.0) ** 0.5)))
                sig *= k
            dogs = jnp.stack([gs[i + 1] - gs[i] for i in range(len(gs) - 1)])
            resp = _dog_extrema(dogs, contrast_thresh=0.005)
            mm = margin_mask(oh, ow, hl, hr, vl, vr)
            mm = mm * margin_mask(oh, ow, 8.0 / ow, 8.0 / ow, 8.0 / oh,
                                  8.0 / oh)
            resp = jnp.where(mm[None] > 0, resp, -jnp.inf)
            kk = max_keypoints
            # per-octave candidate selection, exact
            score, flat = jax.lax.top_k(resp.reshape(-1), kk)
            per = oh * ow
            sflat = flat % per
            sidx = flat // per
            ui = (sflat % ow).astype(jnp.int32)
            vi = (sflat // ow).astype(jnp.int32)

            # subpixel refinement: 2D quadratic fit on the keypoint's DoG
            # response neighborhood (offset = -H^-1 g, clamped to +-0.5).
            # Direct per-keypoint element gathers: indexing dogs[sidx]
            # would materialize a [K,H,W] slice per octave
            ssel = jnp.clip(sidx + 1, 0, dogs.shape[0] - 1)

            def at(dy, dx):
                yy2 = jnp.clip(vi + dy, 0, oh - 1)
                xx2 = jnp.clip(ui + dx, 0, ow - 1)
                return jnp.abs(dogs[ssel, yy2, xx2])

            gx = 0.5 * (at(0, 1) - at(0, -1))
            gy = 0.5 * (at(1, 0) - at(-1, 0))
            hxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
            hyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
            hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
            det = hxx * hyy - hxy * hxy
            det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
            offx = jnp.clip(-(hyy * gx - hxy * gy) / det, -0.5, 0.5)
            offy = jnp.clip(-(hxx * gy - hxy * gx) / det, -0.5, 0.5)

            uu = (ui.astype(jnp.float32) + offx) * (2.0 ** octave)
            vv = (vi.astype(jnp.float32) + offy) * (2.0 ** octave)
            all_uv.append(jnp.stack([uu, vv], -1))
            all_score.append(score)

            # scale interpolation: 1D quadratic fit along the DoG scale
            # axis at the keypoint pixel (same -g/H recipe as the spatial
            # fit), so sigma lands between discrete pyramid levels
            def at_s(ds):
                ss = jnp.clip(sidx + 1 + ds, 0, dogs.shape[0] - 1)
                return jnp.abs(dogs[ss, jnp.clip(vi, 0, oh - 1),
                                    jnp.clip(ui, 0, ow - 1)])

            gs1 = 0.5 * (at_s(1) - at_s(-1))
            hss = at_s(1) + at_s(-1) - 2 * at_s(0)
            hss = jnp.where(jnp.abs(hss) < 1e-12, -1e-12, hss)
            offs = jnp.clip(-gs1 / hss, -0.5, 0.5)

            # sampling step ~ the level's sigma in source pixels
            lvl_sigma = sigma0 * (k ** (sidx.astype(jnp.float32) + 1.0 +
                                        offs))
            all_scale.append(lvl_sigma / sigma0 * (2.0 ** octave))
            if octave + 1 < num_levels:
                base = _downsample2(gs[scales_per_octave])
    else:
        levels = []
        cur = gaussian_blur(img, 1.0)
        for lv in range(num_levels):
            levels.append(cur)
            if lv + 1 < num_levels:
                cur = _downsample2(gaussian_blur(cur, 1.2))
        for lv, lim in enumerate(levels):
            lh, lw = lim.shape
            r = _harris(lim)
            mm = margin_mask(lh, lw, hl, hr, vl, vr)
            mm = mm * margin_mask(lh, lw, 8.0 / lw, 8.0 / lw, 8.0 / lh,
                                  8.0 / lh)
            r = jnp.where((mm > 0) & _nms3(r), r, -jnp.inf)
            score, flat = jax.lax.top_k(r.ravel(), max_keypoints)
            uu = (flat % lw).astype(jnp.float32) * (2.0 ** lv)
            vv = (flat // lw).astype(jnp.float32) * (2.0 ** lv)
            all_uv.append(jnp.stack([uu, vv], -1))
            all_score.append(score)
            all_scale.append(jnp.full((max_keypoints,), 2.0 ** lv))

    uv = jnp.concatenate(all_uv)
    score = jnp.concatenate(all_score)
    scale = jnp.concatenate(all_scale)
    score_top, sel = jax.lax.top_k(score, max_keypoints)
    uv = uv[sel]
    scale = scale[sel]

    # octave-downsampled Gaussian gradient pyramid in half-octave sigma
    # steps (sigma_l = 1.6 * 2^(l/2)); every keypoint samples orientation
    # and descriptor gradients from the level matching its scale — the
    # Lowe-correct smoothing that keeps gradient directions isotropic —
    # through _sample_grad_patches
    n_oct = max(num_levels, 1)
    n_glv = 2 * n_oct
    gx_atlas, gy_atlas, gmeta = _grad_pyramid(img, n_oct)
    glvl = _grad_level(scale, n_glv)

    ang1, ang2, ratio2 = _orientation_batch((gx_atlas, gy_atlas), gmeta,
                                            glvl, uv, scale)
    # dual orientation (SIFT): keypoints with a rival histogram peak
    # >= 0.8*max also enter at the second angle; the final top-K keeps
    # capacity static (secondary copies get an epsilon score penalty so
    # they never evict their primaries)
    score2 = jnp.where(ratio2 >= 0.8, score_top * (1.0 - 1e-6), -jnp.inf)
    uv = jnp.concatenate([uv, uv])
    scale = jnp.concatenate([scale, scale])
    ang = jnp.concatenate([ang1, ang2])
    score_all = jnp.concatenate([score_top, score2])
    score_top, sel = jax.lax.top_k(score_all, max_keypoints)
    uv = uv[sel]
    scale = scale[sel]
    ang = ang[sel]
    valid = jnp.isfinite(score_top) & (score_top > min_score)

    glvl = _grad_level(scale, n_glv)
    desc = _descriptor_batch((gx_atlas, gy_atlas), gmeta, glvl, uv, scale,
                             ang)
    desc = jnp.where(valid[:, None], desc, 0.0)
    return Keypoints(uv, scale, ang, score_top, valid, desc)


@partial(jax.jit, static_argnames=("max_keypoints", "num_levels",
                                   "margins", "min_score", "detector",
                                   "scales_per_octave"))
def detect_batch(grays: jnp.ndarray, **kw) -> Keypoints:
    """vmap detect_and_describe over a batch of images [N,H,W] — the
    equivalent of DetectFeature's loop (FeatureProc.cpp:103-112).

    Jitted as a whole: a bare eager vmap inlines the inner jit and
    dispatches every batched primitive from the host one by one."""
    return jax.vmap(lambda g: detect_and_describe(g, **kw))(grays)
