"""Feature detection and description (jitted).

Harris corner response with fixed-size top-K selection (static shapes for
XLA), plus a simple normalized-patch descriptor. Everything is expressed
as convolutions/reductions that XLA fuses; no data-dependent shapes
anywhere (corner count is a static K with validity scores, the
static-shape equivalent of thresholding).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _sobel(img):
    kx = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], img.dtype) / 8.0
    ky = kx.T
    pad = jnp.pad(img, 1, mode="edge")
    win = jax.lax.conv_general_dilated(
        pad[None, None], jnp.stack([kx, ky])[:, None],
        window_strides=(1, 1), padding="VALID",
    )[0]
    return win[0], win[1]


def _box_blur(x, radius=1):
    k = 2 * radius + 1
    kern = jnp.ones((k, k), x.dtype) / (k * k)
    pad = jnp.pad(x, radius, mode="edge")
    return jax.lax.conv_general_dilated(
        pad[None, None], kern[None, None], (1, 1), "VALID"
    )[0, 0]


@functools.partial(jax.jit, static_argnames=("k",))
def harris_corners(img, k: int = 256, kappa: float = 0.04):
    """Top-k Harris corners of a grayscale image [H, W].

    Returns (xy [k,2] float (x, y) pixel coords, score [k]). Non-maximum
    suppression is a 3x3 max-pool equality test; border responses are
    zeroed so descriptors always have full patches."""
    img = img.astype(jnp.float32)
    ix, iy = _sobel(img)
    sxx = _box_blur(ix * ix)
    syy = _box_blur(iy * iy)
    sxy = _box_blur(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    R = det - kappa * tr * tr
    # 3x3 non-maximum suppression
    mx = jax.lax.reduce_window(
        R, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    R = jnp.where(R >= mx, R, 0.0)
    b = 8  # border margin for descriptor patches
    H, W = img.shape
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    R = jnp.where(inside, R, 0.0)
    score, idx = jax.lax.top_k(R.reshape(-1), k)
    y, x = idx // W, idx % W
    return jnp.stack([x, y], axis=1).astype(jnp.float32), score


@functools.partial(jax.jit, static_argnames=("patch",))
def describe(img, xy, patch: int = 8):
    """Normalized patch descriptors [k, patch*patch] at integer corners."""
    img = img.astype(jnp.float32)
    half = patch // 2

    def one(p):
        x0 = p[0].astype(jnp.int32) - half
        y0 = p[1].astype(jnp.int32) - half
        w = jax.lax.dynamic_slice(img, (y0, x0), (patch, patch))
        w = w - jnp.mean(w)
        return (w / (jnp.linalg.norm(w) + 1e-6)).reshape(-1)

    return jax.vmap(one)(xy)


def detect_and_describe(img, k: int = 256, patch: int = 8):
    """(xy [k,2], score [k], desc [k, patch^2])."""
    xy, score = harris_corners(img, k=k)
    return xy, score, describe(img, xy, patch=patch)
