"""Regenerate the AVIF fixtures of ``tests/test_torch_avif.py`` and
``chip_smoke.py`` and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif/make_avif.py

The JAX package's CLI (``python -m oavif_tpu.cli``) writes the streams of
the port's toolset: the six bench classes at 512x512 at ``-t 80``,
``chip_smoke.frame_4k()`` at ``-q 60``, and at ``-q 60`` on 256x256
crops one stream per tool the encoder switches on (filter intra at speed
8, Wiener and SGR restoration at speed 5, IDTX under ``--tune ssim``,
palette on ``text``, lossless at ``-q 100``, 8-bit output, alpha lossless
and at ``--quality-alpha 50``, four tiles, 64-pixel superblocks), a
509x383 frame, the CICP 1/13/1 and an ICC profile (lcms's sRGB, its
date zeroed). Pillow's libaom
encoder writes three more (4:2:0, 4:2:2, and 4:4:4 with libaom's intra
edge filter; named ``refuse_*`` because the port's first AV1 decoder
refused them: it decodes them now, and
``tests/torch_fixtures/avif_aom`` holds the wider libaom grid). The
manifest holds, for every file, the CRC32 of the system libavif's
(dav1d's) Y'UV planes as little-endian uint16 (each plane at its own
size), and the shape, depth and CRC32 of the reference's ``load_avif``
pixels and of its ``decode_avif_to_rgb8`` pixels.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image, ImageCms

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

CROP = 256


def write_pam(path: str, arr: np.ndarray) -> None:
    h, w = arr.shape[:2]
    ch = arr.shape[2]
    tt = {3: "RGB", 4: "RGB_ALPHA"}[ch]
    with open(path, "wb") as f:
        f.write(f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\nMAXVAL 255\n"
                f"TUPLTYPE {tt}\nENDHDR\n".encode())
        f.write(np.ascontiguousarray(arr).tobytes())


def cli_files() -> dict:
    """name -> (pixels, CLI arguments, extra environment, ICC or None)"""
    images = bench_images()
    files = {f"{n}.avif": (rgb, ["-t", "80"], {}, None)
             for n, rgb in images.items()}
    mixed = images["mixed"][:CROP, :CROP]
    text = images["text"][:CROP, :CROP]
    q = ["-q", "60"]
    icc = bytearray(
        ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
    icc[24:36] = bytes(12)  # the creation date, so that reruns agree
    icc = bytes(icc)
    files.update({
        "photo4k_q60.avif": (frame_4k(), q, {}, None),
        "tool_filter_intra_s8.avif": (mixed, q + ["-s", "8"], {}, None),
        "tool_restoration_s5.avif": (mixed, q + ["-s", "5"], {}, None),
        "tool_idtx_ssim.avif": (mixed, q + ["--tune", "ssim"], {}, None),
        "tool_palette_text.avif": (text, q, {}, None),
        "tool_lossless.avif": (text, ["-q", "100"], {}, None),
        "tool_8bit.avif": (mixed, q + ["--tenbit", "0"], {}, None),
        "tool_alpha_lossless.avif": (with_alpha(mixed),
                                     q + ["--quality-alpha", "100"], {},
                                     None),
        "tool_alpha_q50.avif": (with_alpha(mixed),
                                q + ["--quality-alpha", "50"], {}, None),
        "tool_tiles4.avif": (mixed, q + ["--auto-tiling", "0",
                                         "--tile-cols-log2", "1",
                                         "--tile-rows-log2", "1"], {},
                             None),
        "tool_sb64.avif": (mixed, q, {"OAVIF_SB128": "0"}, None),
        "odd_509x383.avif": (images["mixed"][:383, :509], q, {}, None),
        "cicp_1_13_1.avif": (mixed, q + ["--color-primaries", "1",
                                         "--transfer-characteristics", "13",
                                         "--matrix-coefficients", "1"], {},
                             None),
        "icc.avif": (mixed, q, {}, icc),
    })
    return files


# name -> Pillow save keywords of the files libaom writes
LIBAOM = {
    "refuse_420.avif": dict(subsampling="4:2:0"),
    "refuse_422.avif": dict(subsampling="4:2:2"),
    "refuse_444_edge_filter.avif": dict(subsampling="4:4:4"),
}


def run_cli(name: str, rgb, args, env_extra, icc, td: str) -> None:
    src = os.path.join(td, name + (".png" if icc else ".pam"))
    if icc:
        Image.fromarray(rgb).save(src, icc_profile=icc)
    else:
        write_pam(src, rgb)
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    env.pop("OAVIF_IDTX", None)
    subprocess.run([sys.executable, "-m", "oavif_tpu.cli", *args, src,
                    os.path.join(HERE, name)], check=True, cwd=ROOT, env=env)


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str) -> dict:
    """The entry of one file."""
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    path = os.path.join(HERE, name)
    with open(path, "rb") as f:
        data = f.read()
    img = load_avif(path)
    entry = {"bytes": len(data), "load_shape": list(img.data.shape),
             "load_hbd": img.hbd, "load_crc": crc(img.data),
             "icc": len(img.icc or b""),
             "rgb8_crc": crc(decode_avif_to_rgb8(data))}
    planes, entry["depth"], _ = decode_to_yuv(data)
    entry["yuv_crc"] = crc(np.concatenate(
        [p.astype("<u2").reshape(-1) for p in planes if p is not None]))
    return entry


def write_manifest() -> None:
    names = sorted(cli_files()) + sorted(LIBAOM)
    manifest = {name: manifest_entry(name) for name in names}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> None:
    with tempfile.TemporaryDirectory() as td:
        for name, (rgb, args, env, icc) in cli_files().items():
            print(name, flush=True)
            run_cli(name, rgb, args, env, icc, td)
    src = bench_images(CROP, ("mixed",))["mixed"]
    for name, kw in LIBAOM.items():
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "AVIF", quality=60, speed=6,
                                  max_threads=1, **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.getvalue())
    write_manifest()


if __name__ == "__main__":
    main()
