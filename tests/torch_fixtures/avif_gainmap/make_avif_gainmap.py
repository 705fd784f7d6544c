"""Regenerate the gain-map AVIF fixtures of
``tests/test_torch_avif_gainmap.py`` and ``chip_smoke.py`` and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_gainmap/make_avif_gainmap.py

A gain map (ISO 21496-1 in HEIF) is a ``tmap`` derived item whose two
``dimg`` references are the base image and the gain map image, its
metadata in the item's data, grouped with the base image in an ``altr``
entity group. The containers are written here
(``avif_lf_seg/keyframe_writer.py``: ``avif_file``) around key frames of
that writer: a 256x192 4:2:0 base image (or a 2x1 ``grid`` of 128x192
cells, or a 10-bit 4:4:4 one) and a 128x128 monochrome gain map.

Pillow's libavif 1.3 decodes the colour image only. Probed case by case,
it then reads a file whatever its ``tmap`` holds: a metadata version or
minimum version it does not know, a denominator of 0, a missing or
mismatched ``ispe``, essential ``irot``/``imir``/``clap`` on the
``tmap``, one or three ``dimg`` entries, a gain map that is no AV1
image, a grid base image beside a single gain map. It refuses a file
whose primary item is the ``tmap`` (it finds no colour item), an item
twice in one ``dimg`` list or in two, two ``dimg`` boxes from one item,
an entity group whose size is not that of its entities, two ``grpl``
boxes, an ``irot``, ``imir`` or ``clap`` not marked essential on any
item, and ``ipma`` entries out of increasing item id order. Each of these
is a file here.

The manifest holds, per file, how it was written and either the fields of
the other AVIF folders (the CRC32 of dav1d's Y'UV of the base image, the
reference's ``load_avif`` and ``decode_avif_to_rgb8`` pixels) or
``raises``: the error Pillow raises, with ``port``: the exception the
port raises (``UnsupportedAvif`` or ``OSError``).
"""

from __future__ import annotations

import copy
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_lf_seg"))

from keyframe_writer import (Block, Frame, Item, av1c, avif_file,  # noqa: E402
                             box, frame_obus, fullbox, ispe, pixi)

BASE, GAIN, TMAP, CELL2, OTHER = 1, 2, 3, 4, 5
NCLX = box(b"colr", b"nclx" + struct.pack(">HHHB", 2, 2, 2, 0x80))
IROT = box(b"irot", b"\x01")
IMIR = box(b"imir", b"\x00")
CLAP = box(b"clap", struct.pack(">8I", 128, 1, 96, 1, 0, 1, 0, 1))


def _frame(w: int, h: int, seed: int, **kw) -> Frame:
    rng = np.random.default_rng(seed)
    fr = Frame(w, h, lf=(10, 10, 10, 10), base_q=160, **kw)
    fr.blocks = [[Block(dc=tuple(int(v) for v in rng.integers(-60, 61, 3)),
                        mode=int(rng.integers(0, 3)))
                  for _ in range(-(-w // 64))] for _ in range(-(-h // 64))]
    return fr


def _props(fr: Frame) -> list:
    return [(ispe(fr.width, fr.height), False), (pixi(fr), False),
            (av1c(fr), True), (NCLX, False)]


def tmap_payload(version: int = 0, minimum: int = 0, writer: int = 0,
                 multichannel: bool = False, den: int = 1) -> bytes:
    """The ``tmap`` item's data (ISO 21496-1 metadata as libavif writes
    it): versions, flags, the headrooms, then per channel the gain map's
    min, max, gamma and the base and alternate offsets as fractions."""
    out = struct.pack(">BHHB", version, minimum, writer,
                      0x80 if multichannel else 0)
    out += struct.pack(">IIII", 0, 1, 2, den)
    for c in range(3 if multichannel else 1):
        out += struct.pack(">iIiIIIiIiI", 0, den, 1 + c, den, 1, den, 1, 64,
                           1, 64)
    return out


def gain_map_file(*, primary: int = BASE, tmap: bytes = None,
                  tmap_props=None, dimg=(BASE, GAIN), refs=(),
                  groups=((b"altr", 10, (TMAP, BASE)),), base: Frame = None,
                  grid: bool = False, gain_item: Item = None,
                  extra_items=(), base_props=None,
                  unordered: bool = False) -> bytes:
    """A base image, a gain map image and a ``tmap`` over both, the items
    in increasing id order, or with ``unordered`` not."""
    base = base or _frame(256, 192, 1)
    gain = _frame(128, 128, 2, mono=True)
    items = []
    if grid:
        half = copy.deepcopy(base)
        half.width = 128
        half.blocks = [row[:2] for row in base.blocks]
        other = copy.deepcopy(half)
        other.blocks = [row[2:] for row in base.blocks]
        desc = struct.pack(">BBBBHH", 0, 0, 0, 1, 256, 192)
        items += [Item(BASE, b"grid", desc, [(ispe(256, 192), False),
                                             (pixi(base), False), (NCLX, False)]),
                  Item(CELL2, b"av01", frame_obus(half), _props(half),
                       hidden=True),
                  Item(OTHER, b"av01", frame_obus(other), _props(other),
                       hidden=True)]
        refs = ((b"dimg", BASE, (CELL2, OTHER)),) + tuple(refs)
    else:
        items.append(Item(BASE, b"av01", frame_obus(base),
                          base_props or _props(base)))
    items.append(gain_item or Item(GAIN, b"av01", frame_obus(gain),
                                   _props(gain), hidden=True))
    items.append(Item(TMAP, b"tmap", tmap_payload() if tmap is None else tmap,
                      [(ispe(256, 192), False)] if tmap_props is None
                      else tmap_props))
    items = sorted(items + list(extra_items), key=lambda it: it.item_id)
    if unordered:  # the grid's cells first, as their ids do not run
        items = items[:1] + items[3:] + items[1:3]
    all_refs = [(b"dimg", TMAP, list(dimg))] if dimg else []
    all_refs += [(t, a, list(b)) for t, a, b in refs]
    return avif_file(items, primary, refs=all_refs,
                     groups=[(t, g, list(ids)) for t, g, ids in groups])


def _with_grpl(data: bytes, grpl: bytes) -> bytes:
    """The file with a hand-made ``grpl`` box put before ``iprp``, the
    ``meta`` size and ``iloc`` offsets moved to match."""
    at = data.index(b"iprp") - 4
    meta = data.index(b"meta") - 4
    out = bytearray(data[:at] + grpl + data[at:])
    size = struct.unpack_from(">I", out, meta)[0]
    struct.pack_into(">I", out, meta, size + len(grpl))
    j = out.index(b"iloc") + 4 + 4 + 2
    for _ in range(struct.unpack_from(">H", out, j)[0]):
        j += 2 + 6
        struct.pack_into(">I", out, j, struct.unpack_from(">I", out, j)[0]
                         + len(grpl))
        j += 8
    return bytes(out)


def files() -> dict:
    """name -> (bytes, how it was written)"""
    ten = _frame(256, 192, 3, ss=(0, 0), bitdepth=10)
    altr = fullbox(b"altr", 0, 0, struct.pack(">IIII", 10, 2, TMAP, BASE))
    other = Item(OTHER, b"av01", frame_obus(_frame(128, 128, 4, mono=True)),
                 _props(_frame(128, 128, 4, mono=True)), hidden=True)
    out = {
        # libavif's layout: the base image primary, the tmap preferred
        # first in the altr group
        "base_primary.avif": gain_map_file(),
        "base_primary_no_altr.avif": gain_map_file(groups=()),
        "base_primary_444_10b.avif": gain_map_file(base=ten),
        "base_primary_grid.avif": gain_map_file(grid=True),
        "tmap_multichannel_colr.avif": gain_map_file(
            tmap=tmap_payload(multichannel=True),
            tmap_props=[(ispe(256, 192), False), (NCLX, False)]),
        # what a gain map decoder checks, and Pillow does not
        "tmap_version1.avif": gain_map_file(tmap=tmap_payload(version=1)),
        "tmap_minimum_version1.avif": gain_map_file(
            tmap=tmap_payload(minimum=1, writer=1)),
        "tmap_denominator0.avif": gain_map_file(tmap=tmap_payload(den=0)),
        "tmap_no_ispe.avif": gain_map_file(tmap_props=[]),
        "tmap_ispe_mismatch.avif": gain_map_file(
            tmap_props=[(ispe(128, 96), False)]),
        "tmap_irot_imir_clap.avif": gain_map_file(
            tmap_props=[(ispe(256, 192), False), (IROT, True), (IMIR, True),
                        (CLAP, True)]),
        "tmap_dimg_one.avif": gain_map_file(dimg=(BASE,)),
        "tmap_dimg_three.avif": gain_map_file(dimg=(BASE, GAIN, OTHER),
                                              extra_items=[other]),
        "gain_map_not_av1.avif": gain_map_file(gain_item=Item(
            GAIN, b"jpeg", b"\xff\xd8\xff\xd9", [(ispe(128, 96), False)],
            hidden=True)),
        # what Pillow refuses
        "tmap_primary.avif": gain_map_file(primary=TMAP),
        "tmap_primary_no_altr.avif": gain_map_file(primary=TMAP, groups=()),
        "dimg_base_twice.avif": gain_map_file(dimg=(BASE, BASE)),
        "dimg_in_two_tmaps.avif": gain_map_file(
            refs=((b"dimg", OTHER, (BASE, GAIN)),),
            extra_items=[Item(OTHER, b"tmap", tmap_payload(),
                              [(ispe(256, 192), False)])]),
        "dimg_two_boxes.avif": gain_map_file(
            dimg=(BASE,), refs=((b"dimg", TMAP, (GAIN,)),)),
        "altr_count_past_end.avif": _with_grpl(
            gain_map_file(groups=()), box(b"grpl", fullbox(
                b"altr", 0, 0, struct.pack(">IIII", 10, 5, TMAP, BASE)))),
        "altr_trailing_bytes.avif": _with_grpl(
            gain_map_file(groups=()), box(b"grpl", fullbox(
                b"altr", 0, 0, struct.pack(">IIIII", 10, 2, TMAP, BASE, 9)))),
        "two_grpl.avif": _with_grpl(gain_map_file(groups=()),
                                    box(b"grpl", altr) * 2),
        "ipma_not_increasing.avif": gain_map_file(grid=True, unordered=True),
        "tmap_irot_not_essential.avif": gain_map_file(
            tmap_props=[(ispe(256, 192), False), (IROT, False)]),
    }
    return {name: (data, {"writer": "make_avif_gainmap.py"})
            for name, data in out.items()}


def crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def base_yuv_crc(data: bytes) -> int:
    """dav1d's Y'UV of the file (the system libavif 0.11.1 ignores the
    gain map items): the CRC32 of the planes as little-endian uint16."""
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    planes, _, _ = decode_to_yuv(data)
    return crc(np.concatenate([p.astype("<u2").reshape(-1) for p in planes
                               if p is not None]))


def manifest_entry(name: str, data: bytes, how: dict) -> dict:
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A

    path = os.path.join(HERE, name)
    entry = {"bytes": len(data), "written": how}
    try:
        img = load_avif(path)
    except Exception as e:
        try:
            A.decode_avif(data)
        except (A.UnsupportedAvif, OSError) as p:
            entry.update(raises=str(e).replace(path, name),
                         port=type(p).__name__, port_says=str(p))
            return entry
        raise RuntimeError(f"{name}: the reference raises, the port reads")
    box_, port, _ = A.decode_avif(data)
    entry.update(load_shape=list(img.data.shape), load_hbd=img.hbd,
                 load_crc=crc(img.data), icc=len(img.icc or b""), rgb8_crc=crc(decode_avif_to_rgb8(
                     data)), yuv_crc=base_yuv_crc(data), tools=port.tools,
                 grid=box_.color.grid is not None)
    return entry


def main() -> None:
    manifest = {}
    for name, (data, how) in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = manifest_entry(name, data, how)
        print(name, len(data), manifest[name].get("raises", "reads"),
              flush=True)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
