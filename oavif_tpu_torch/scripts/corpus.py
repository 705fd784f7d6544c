"""The port's bench corpus: the six image classes of the reference's
``bench.py`` (copies of its generators, with its seeds), and writers of
an (h, w, 3) uint8 image as a Netpbm PAM or as an 8-bit PNG.

    python -m oavif_tpu_torch.scripts.corpus DIR [--size 512]

writes the six classes into DIR as PNG (the corpus of
``scripts/measure.py``).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np

CLASSES = ("sinusoid", "fractal", "edges", "oriented", "text", "mixed")


def write_pam(path: str, rgb: np.ndarray) -> None:
    """Write an (h, w, 3) uint8 image as a Netpbm PAM (P7) file."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
                f"TUPLTYPE RGB\nENDHDR\n".encode())
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (h, w, 3) uint8 image as an 8-bit truecolor PNG, every row
    with the Up filter (the difference from the row above)."""
    h, w = rgb.shape[:2]
    rows = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(h, w * 3)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * 3), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _img_sinusoid(h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
            120 + 80 * np.cos(xx / 29.0) + 20 * np.sin(yy / 7.0),
            100 + 90 * np.sin((xx + yy) / 31.0),
        ],
        -1,
    )
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_fractal(h, w, seed=11):
    """1/f ("pink") random field per channel — the spectral shape of
    natural photographs."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    chans = []
    for c in range(3):
        spec = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) / rad
        f = np.real(np.fft.ifft2(spec))
        f = (f - f.min()) / (f.max() - f.min())
        chans.append(40 + 175 * f)
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def _img_edges(h, w, seed=13):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    g = np.where((xx // 37 + yy // 23) % 2 == 0, 205.0, 70.0)
    g += np.where((xx + 2 * yy) % 97 < 8, 40.0, 0.0)
    img = np.stack([g, 0.85 * g + 20, 255 - 0.7 * g], -1)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_oriented(h, w, seed=17):
    """Angled stripes with a slowly drifting orientation — the content
    class directional intra and rect partitions exist for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ang = 0.55 + 0.25 * np.sin(yy / 140.0)
    phase = xx * np.cos(ang) + yy * np.sin(ang)
    g = 128 + 62 * np.sin(phase / 4.3) + 18 * np.sin(phase / 23.0)
    img = np.stack([g, 0.88 * g + 14, 238 - 0.62 * g], -1)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_text(h, w, seed=19):
    """Text-like glyph strokes on a smooth gradient — screen content
    (the palette/IDTX class)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 60 + 140 * (xx + yy) / (h + w)  # diagonal gradient background
    glyph = np.zeros((h, w))
    for row in range(8, h - 16, 22):
        x = 10
        while x < w - 20:
            cw = int(rng.integers(4, 14))
            if rng.random() < 0.75:
                glyph[row : row + 12, x : x + 2] = 1  # vertical stroke
                if rng.random() < 0.5:
                    glyph[row : row + 2, x : x + cw] = 1  # top bar
                if rng.random() < 0.5:
                    glyph[row + 10 : row + 12, x : x + cw] = 1
            x += cw + 4
    g = np.where(glyph > 0, 16.0, g)
    img = np.stack([g, g * 0.96 + 4, g * 1.02], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_mixed(h, w, seed=23):
    """Mixed-scale structure: large smooth areas with embedded
    fine-detail patches — exercises partition adaptivity."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 110 + 70 * np.sin(xx / 190.0) * np.cos(yy / 160.0)
    for _ in range(10):
        py, px = rng.integers(0, h - 72), rng.integers(0, w - 72)
        ph, pw = rng.integers(28, 72), rng.integers(28, 72)
        fy, fx = rng.uniform(2.5, 6.0), rng.uniform(2.5, 6.0)
        sub = np.mgrid[0:ph, 0:pw]
        g[py : py + ph, px : px + pw] = 128 + 58 * np.sin(
            sub[1] / fx
        ) * np.cos(sub[0] / fy)
    img = np.stack([g, 0.9 * g + 12, 250 - 0.68 * g], -1)
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_images(size: int = 512, classes=CLASSES) -> dict:
    """The bench classes (all six unless told) at size x size."""
    gens = globals()
    return {name: gens[f"_img_{name}"](size, size) for name in classes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, rgb in bench_images(args.size).items():
        write_png(os.path.join(args.out_dir, f"{name}.png"), rgb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
