"""The synthetic RGB-D world, rendered on the card.

A PyTorch copy of the port's ``datasets/synthetic.py`` scene: textured 3-D
rectangles (walls, floor, boxes and movers) rendered by vectorised
ray-rectangle intersection, with the moving rectangles giving a known
dynamic mask. The rectangles come from a deployment file's ``scene``, the
textures from its ``texture_seed``, and every frame of the sequence is rendered in
float64 on the device once, in set-up, in chunks of frames.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch


class Rect(NamedTuple):
    origin: np.ndarray   # (3,) corner
    eu: np.ndarray       # (3,) edge along texture-u
    ev: np.ndarray       # (3,) edge along texture-v
    color: Optional[np.ndarray]  # (3,) base colour, None: drawn
    dynamic: bool


def noise_texture(rng: np.random.Generator, size: int = 256,
                  octaves: int = 4, base_color=None) -> np.ndarray:
    """Multi-octave value noise with a checker overlay, (size, size, 3) in
    [0, 1]: the port's ``_noise_texture``, draw for draw."""
    tex = np.zeros((size, size), dtype=np.float64)
    for o in range(octaves):
        n = 4 * (2 ** o)
        coarse = rng.uniform(0, 1, (n + 1, n + 1))
        ys = np.linspace(0, n, size)
        xs = np.linspace(0, n, size)
        y0 = np.clip(ys.astype(int), 0, n - 1)
        x0 = np.clip(xs.astype(int), 0, n - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c00 = coarse[np.ix_(y0, x0)]
        c01 = coarse[np.ix_(y0, x0 + 1)]
        c10 = coarse[np.ix_(y0 + 1, x0)]
        c11 = coarse[np.ix_(y0 + 1, x0 + 1)]
        tex += (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
                + c10 * fy * (1 - fx) + c11 * fy * fx) / (2 ** o)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    yy, xx = np.mgrid[0:size, 0:size]
    checker = (((yy // 16) + (xx // 16)) % 2).astype(np.float64)
    tex = 0.7 * tex + 0.3 * checker
    if base_color is None:
        base_color = rng.uniform(0.3, 1.0, 3)
    return np.clip(tex[..., None] * np.asarray(base_color)[None, None, :],
                   0, 1)


def rects_of(scene: dict) -> List[Rect]:
    """The rectangles of a deployment's ``scene``: its static ``rects``, then
    its ``movers``, each ``{"origin", "eu", "ev", "color"}``."""
    out = []
    for spec, dynamic in ([(r, False) for r in scene["rects"]]
                          + [(m, True) for m in scene["movers"]]):
        color = spec.get("color")
        out.append(Rect(np.asarray(spec["origin"], float),
                        np.asarray(spec["eu"], float),
                        np.asarray(spec["ev"], float),
                        None if color is None else np.asarray(color, float),
                        dynamic))
    return out


def textures(rects: List[Rect], seed: int) -> List[np.ndarray]:
    """One texture a rectangle, in order, from one generator seeded with
    ``seed``."""
    rng = np.random.default_rng(seed)
    return [noise_texture(rng, base_color=r.color) for r in rects]


def _trunc(x: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``astype(int)`` (toward zero) on the texels' range; what
    lies outside it, or is not a number, is off the rectangle anyway."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(x, -1.0, float(n)).to(torch.int64)


def render(rects: List[Rect], texs: List[torch.Tensor], cam: dict,
           T_wc: torch.Tensor, offsets: torch.Tensor):
    """Render F frames: ``T_wc`` (F, 4, 4) camera-to-world poses and
    ``offsets`` (F, R, 3) world translations of each rectangle (zero for
    static ones), float64 on the rendering device; ``texs`` the (Tv, Tu, 3)
    float64 textures there. Returns (rgb (F, H, W, 3) uint8, depth (F, H, W)
    float32 metres, dynamic mask (F, H, W) bool)."""
    dev = T_wc.device
    f64 = torch.float64
    H, W = int(cam["height"]), int(cam["width"])
    n = T_wc.shape[0]
    R, t = T_wc[:, :3, :3], T_wc[:, :3, 3]
    vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    dirs_cam = torch.stack([(us - cam["cx"]) / cam["fx"],
                            (vs - cam["cy"]) / cam["fy"],
                            torch.ones_like(us)], -1)          # (H, W, 3)
    dirs = torch.einsum("hwk,fjk->fhwj", dirs_cam, R)         # world rays
    origin = t[:, None, None, :]                               # (F,1,1,3)
    best_t = torch.full((n, H, W), float("inf"), dtype=f64, device=dev)
    rgb = torch.zeros((n, H, W, 3), dtype=f64, device=dev)
    dyn = torch.zeros((n, H, W), dtype=torch.bool, device=dev)
    for ri, (rect, tex) in enumerate(zip(rects, texs)):
        eu = torch.as_tensor(rect.eu, dtype=f64, device=dev)
        ev = torch.as_tensor(rect.ev, dtype=f64, device=dev)
        ro = torch.as_tensor(rect.origin, dtype=f64, device=dev) \
            + offsets[:, ri]                                   # (F, 3)
        nrm = torch.linalg.cross(eu, ev)
        denom = dirs @ nrm                                     # (F, H, W)
        t_hit = (((ro - t) @ nrm)[:, None, None]) / denom
        p = origin + dirs * t_hit[..., None]
        d = p - ro[:, None, None, :]
        a = (d @ eu) / (eu @ eu)
        b = (d @ ev) / (ev @ ev)
        hit = ((denom.abs() > 1e-9) & (t_hit > 0.05) & (a >= 0) & (a <= 1)
               & (b >= 0) & (b <= 1) & (t_hit < best_t))
        Tv, Tu = tex.shape[:2]
        ti = torch.clamp(_trunc(b * (Tv - 1), Tv), 0, Tv - 1)
        tj = torch.clamp(_trunc(a * (Tu - 1), Tu), 0, Tu - 1)
        rgb = torch.where(hit[..., None], tex[ti, tj], rgb)
        dyn = torch.where(hit, rect.dynamic, dyn)
        best_t = torch.where(hit, t_hit, best_t)
    finite = torch.isfinite(best_t)
    p_world = origin + dirs * torch.where(finite, best_t, 0.0)[..., None]
    p_cam = torch.einsum("fhwj,fjk->fhwk", p_world - origin, R)
    depth = torch.where(finite, p_cam[..., 2], 0.0).to(torch.float32)
    rgb_u8 = (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)
    return rgb_u8, depth, dyn
