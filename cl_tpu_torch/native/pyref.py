"""Pure-Python reference of the native rasterizer (oracle + fallback).

Implements bit-for-bit the same splitmix64 → xoshiro256++ stream and
rasterization as rasterizer.cpp; tests assert byte-identical output. Slow —
used when the C++ toolchain is unavailable and in tests.
"""

from __future__ import annotations

import math

import numpy as np

_M = (1 << 64) - 1


def _splitmix_seq(x: int):
    while True:
        x = (x + 0x9E3779B97F4A7C15) & _M
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M
        yield (z ^ (z >> 31)) & _M


class Xoshiro:
    def __init__(self, seed: int):
        g = _splitmix_seq(seed & _M)
        self.s = [next(g) for _ in range(4)]

    @staticmethod
    def _rotl(v: int, k: int) -> int:
        return ((v << k) | (v >> (64 - k))) & _M

    def next(self) -> int:
        s = self.s
        result = (self._rotl((s[0] + s[3]) & _M, 23) + s[0]) & _M
        t = (s[1] << 17) & _M
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    def randint(self, lo: int, hi: int) -> int:
        rng = hi - lo
        while True:
            x = self.next()
            r = x % rng
            if x - r <= _M - rng + 1:
                return lo + r

    def uniform(self) -> float:
        return (self.next() >> 11) * (2.0 ** -53)


def _class_color(cls: int) -> np.ndarray:
    h = math.fmod(cls * 0.61803398875, 1.0)
    i = int(h * 6)
    f = h * 6 - i
    v, sa = 0.9, 0.75
    p, q, t = v * (1 - sa), v * (1 - f * sa), v * (1 - (1 - f) * sa)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
           (v, p, q)][i % 6]
    return np.array([int(c * 255) for c in rgb], np.int16)


def rasterize(seed: int, index: int, size: int, classes,
              max_shapes: int = 4) -> tuple[np.ndarray, np.ndarray]:
    rng = Xoshiro((seed * 1000003 + index + 0x5BF03635) & _M)
    S = size
    img = np.empty((S, S, 3), np.uint8)
    mask = np.zeros((S, S), np.uint8)
    base = [rng.randint(16, 72) for _ in range(3)]
    flat = img.reshape(-1, 3)
    for p in range(S * S):
        for c in range(3):
            flat[p, c] = min(255, max(0, base[c] + rng.randint(-12, 13)))
    classes = list(classes)
    n_shapes = rng.randint(1, max_shapes + 1)
    for _ in range(n_shapes):
        cls = classes[rng.randint(0, len(classes))]
        cy = rng.randint(S // 8, S - S // 8)
        cx = rng.randint(S // 8, S - S // 8)
        # max(1, ·): tiny sizes (<10 px) can draw a 0 radius → div-by-zero
        # degenerate (empty shape); must stay bit-identical to the C++.
        ry = max(1, rng.randint(S // 10, S // 3))
        rx = max(1, rng.randint(S // 10, S // 3))
        ellipse = rng.uniform() < 0.5
        color = _class_color(cls)
        jitter = np.array([rng.randint(-20, 21) for _ in range(3)], np.int16)
        y0, y1 = max(0, cy - ry), min(S - 1, cy + ry)
        x0, x1 = max(0, cx - rx), min(S - 1, cx + rx)
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        if ellipse:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:
            inside = np.ones_like(yy, bool)
        px = np.clip(color + jitter, 0, 255).astype(np.uint8)
        region_img = img[y0:y1 + 1, x0:x1 + 1]
        region_img[inside] = px
        mask[y0:y1 + 1, x0:x1 + 1][inside] = cls
    return img, mask
