"""The port's AVIF reader on items whose inter frames hold global motion of
every type (spec 5.9.24, 7.10.2.1, 7.11.3.1: TRANSLATION, ROTZOOM and
AFFINE, each block's GlobalMvs and the global warp) and skip_mode blocks
(spec 5.9.22, 5.11.10, 5.11.18-25), on the fixtures of
``tests/torch_fixtures/avif_globalmv`` (frames ``avif_layers/
inter_writer.py`` writes over libaom 3.6's layers, judged by dav1d), on
the CPU and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  the port's ``load_avif`` and ``decode_avif_to_rgb8`` pixels are the
  reference's, held live to the reference and to the manifest, with the
  frames the port decodes, the layer it shows, its tool counts and each
  frame's count of compound blocks, global sides and skip_mode blocks
  (the 3840x2160 file decoded by the port once);
- ``global_motion_params`` reads what the writer codes against any
  PrevGmParams, at either MV precision;
- two small files regenerate byte for byte from the maker;
- every new counter occurs, and the set is covered;
- the skip_mode CDF the reader carries is libaom's, read live;
- the global warp's time comes back for the frames that warp and for no
  other;
- the CLI ``-t 80`` on the 512x512 mixed class with both tools gives the
  reference CLI's q and passes, and the bytes of the port's CLI on its
  pixels as PAM.
"""

from __future__ import annotations

import json
import re
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1.obu import BitWriter  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)
from oavif_tpu_torch.scripts import extract_av1_tool_tables as X  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_globalmv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
import make_avif_globalmv as MK  # noqa: E402
import inter_writer as W  # noqa: E402

COUNTERS = A.TOOL_NAMES[A.TOOL_NAMES.index("global_translation"):
                        A.TOOL_NAMES.index("interintra")]


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_dav1d_and_the_reference(name):
    path, entry = FIXTURES / name, MANIFEST[name]
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    planes, depth, _ = decode_to_yuv(data)
    assert (_yuv_crc(planes), depth) == (entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    box, img, alpha = A.decode_avif(data)
    av1 = A.parse_av1(box.color.payload)
    assert [[f.spatial_id, f.frame.frame_type] for f in av1.frames] == \
        entry["frames"]
    assert av1.spatial_id == entry["shows_layer"]
    assert [[f.frame.coded_width, f.frame.width, f.frame.height]
            for f in av1.frames] == entry["sizes"]
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    assert [sum(t[m] for m in MK.MODES) for t in img.frame_tools] == \
        entry["compound"]
    assert [sum(t[k] for k in MK.GLOBAL) for t in img.frame_tools] == \
        entry["global"]
    assert [t["skip_mode"] for t in img.frame_tools] == entry["skip_mode"]
    if entry["load_shape"][1] >= 3840:
        # load_avif's and decode_avif_to_rgb8's pixels of this one decode
        arr, hbd, _ = A.avif_pixels(box, img, alpha)
        rgb8 = A.yuv_to_rgb8(img, rgba=alpha is not None,
                             prem=alpha if box.premultiplied else None)
    else:
        got = load_avif(str(path))
        arr, hbd, rgb8 = got.data, got.hbd, decode_avif_to_rgb8(data)
    assert (arr.dtype, hbd) == (ref.data.dtype, ref.hbd)
    np.testing.assert_array_equal(arr, ref.data)
    assert _crc(rgb8) == entry["rgb8_crc"]


@pytest.mark.parametrize("hp", [False, True])
def test_global_motion_params_read_what_is_coded(hp):
    """Random global motion of every type for LAST..ALTREF, coded against
    random PrevGmParams (and against the identity, as after
    primary_ref_frame 7 or error_resilient_mode), reads back exactly;
    TRANSLATION's precision follows allow_high_precision_mv."""
    rng = np.random.default_rng(int(hp))
    one = 1 << 16

    def params(typ):
        p = [0, 0, one, 0, 0, one]
        if typ >= MK.ROTZOOM:
            p[2] = one + 2 * int(rng.integers(-4096, 4097))
            p[3] = 2 * int(rng.integers(-4096, 4097))
            p[4], p[5] = (-p[3], p[2]) if typ == MK.ROTZOOM else (
                2 * int(rng.integers(-4096, 4097)),
                one + 2 * int(rng.integers(-4096, 4097)))
        if typ == MK.TRANSLATION:
            bits, shift = (9, 13) if hp else (8, 14)
            p[:2] = [int(rng.integers(-(1 << bits), (1 << bits) + 1))
                     << shift for _ in range(2)]
        elif typ:
            p[:2] = [int(rng.integers(-4096, 4097)) << 10 for _ in range(2)]
        return tuple(p)

    for _ in range(40):
        gm = [(int(t), params(int(t))) for t in rng.integers(0, 4, 7)]
        prev = [params(int(t)) for t in rng.integers(0, 4, 7)]
        for against in (prev, None):
            w = BitWriter()
            W.global_motion(w, gm, against or (W.GM_IDENTITY,) * 7, hp)
            w.trailing_bits()
            fh = A.FrameHeader(allow_hp=hp)
            A._global_motion_params(A._Bits(w.data()), fh, against)
            assert list(fh.gm_type) == [t for t, _ in gm]
            assert list(fh.gm_params) == [p for _, p in gm]


@pytest.mark.parametrize("name", ["affine_motion_mono.avif",
                                  "skip_fwd_mono_12bit.avif"])
def test_fixture_regenerates(name):
    assert MK.written(name)[0] == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", COUNTERS)
def test_each_counter_occurs(tool):
    assert sum(e["tools"][tool] for e in MANIFEST.values()) > 0


def _frames(name):
    return A.parse_av1(A.read_container(
        (FIXTURES / name).read_bytes()).color.payload).frames


def test_fixtures_cover_the_set():
    """Each global type on single-reference blocks beside NEARESTMV,
    NEARMV and NEWMV ones, at both MV precisions, 4x4 blocks among them;
    TRANSLATION with unequal x and y of opposite signs; a shear the warp
    refuses; OBMC and LOCALWARP beside global blocks; GLOBAL_GLOBALMV with
    both sides warped, a warped and a translated side, and a scaled side;
    gm_params coded against PrevGmParams that are not the identity;
    skip_mode on a forward and backward pair and on two forward
    references, with delta q, with 128-pixel superblocks and beside global
    motion; every subsampling at 8, 10 and 12 bits; the mixed class and
    the 3840x2160 frame with both tools."""
    M = MANIFEST
    for name, e in M.items():
        t = e["tools"]
        if e["written"].get("gm"):
            assert e["global"][-1] > 0, name
        if name.startswith(("translation", "rotzoom", "affine", "invalid")):
            assert all(t[k] for k in ("globalmv", "nearestmv", "nearmv",
                                      "newmv")), name
    fh = _frames("translation_420.avif")[-1].frame
    x, y = fh.gm_params[0][:2]
    assert fh.gm_type[0] == MK.TRANSLATION and x * y < 0 and abs(x) != abs(y)
    assert fh.allow_hp and not _frames(
        "translation_nohp_422_10bit.avif")[-1].frame.allow_hp
    for name in ("translation_420.avif", "rotzoom_444_12bit.avif"):
        assert 0 in M[name]["written"]["leaves"]
    assert M["rotzoom_444_12bit.avif"]["tools"]["global_rotzoom"] > 0
    assert M["affine_motion_mono.avif"]["tools"]["global_affine"] > 0
    assert M["invalid_shear_420_10bit.avif"]["tools"][
        "global_warp_invalid"] > 0
    motion = M["affine_motion_mono.avif"]["tools"]
    assert motion["obmc"] and motion["local_warp"] and motion["global_warp"]
    for name, types in (("compound_warp_444.avif", (2, 3)),
                        ("compound_mixed_422_12bit.avif", (3, 1))):
        fh = _frames(name)[-1].frame
        pair = M[name]["written"]["pair"]
        assert tuple(fh.gm_type[r - 1] for r in pair) == types
        assert M[name]["tools"]["global_globalmv"] > 0
        assert M[name]["tools"]["global_warp"] > 0
    scaled = M["compound_scaled_420.avif"]
    assert scaled["sizes"][0][1] * 2 == scaled["sizes"][-1][1]
    assert scaled["tools"]["global_globalmv"] and scaled["tools"][
        "compound_scaled"]
    first, second = _frames("chain_prev_gm_420.avif")[1:]
    prim = second.frame.primary_ref_frame
    assert prim != 7 and first.frame.refresh_frame_flags >> \
        second.frame.ref_frame_idx[prim] & 1
    assert any(t > 0 for t in first.frame.gm_type)
    assert all(v > 0 for v in M["chain_prev_gm_420.avif"]["global"][1:])
    for name, bidir in (("skip_bidir_444_10bit.avif", True),
                        ("skip_fwd_mono_12bit.avif", False)):
        fh = _frames(name)[-1].frame
        assert fh.skip_mode_present
        a, b = fh.skip_mode_frames
        assert (fh.sign_bias[a] != fh.sign_bias[b]) == bidir
        assert M[name]["skip_mode"][-1] > 0
        t = M[name]["tools"]
        assert t["newmv"] and sum(t[m] for m in (
            "nearest_nearestmv", "global_globalmv", "new_newmv")) > 0
    assert M["skip_delta_q_420_12bit.avif"]["tools"]["delta_q"] > 0
    assert A.parse_av1(A.read_container((
        FIXTURES / "skip_sb128_422.avif").read_bytes()).color.payload).seq.sb128
    both = [n for n, e in M.items() if e["skip_mode"][-1] and
            e["global"][-1]]
    assert {"class_mixed_512.avif", "photo4k_420.avif"} <= set(both)
    cells = {(e["written"]["depth"], "mono" if e["written"]["mono"]
              else e["written"]["ss"]) for e in M.values()}
    assert cells >= {(d, s) for d in (8, 10, 12)
                     for s in ("4:2:0", "4:2:2", "4:4:4", "mono")}
    photo = M["photo4k_420.avif"]
    assert photo["load_shape"] == [2160, 3840, 3]
    assert photo["bytes"] < 400_000
    assert M["class_mixed_512.avif"]["load_shape"] == [512, 512, 3]
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == sorted(M)


def test_skip_mode_cdf_is_libaom():
    """The skip_mode CDF the reader carries (``av1_tool_tables.npz``)
    against the system libaom, read live, and in the reader's CDF pack."""
    t = A._tool_tables()
    live = X.skip_mode_cdf(X.section(X.LIBAOM))
    np.testing.assert_array_equal(t["skip_mode"], live)
    assert tuple(32768 - live[:, 0].astype(int)) == X.SKIP_MODE
    pack = A._reader_cdfs()["skip_mode"]
    np.testing.assert_array_equal(pack[:, :2], live)


def test_global_warp_time_leaves_the_decode_alone():
    """``decode_avif``'s times take the time of the global warp in the
    frames that warp (both written frames of the chained file) and in no
    other, without changing a sample."""
    data = (FIXTURES / "chain_prev_gm_420.avif").read_bytes()
    want = A.decode_avif(data)[1].planes
    times = {}
    got = A.decode_avif(data, times)[1].planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in (1, 2):
        assert 0 < times[f"gwarp_f{i}"] < times[f"tiles_f{i}"]
    assert "gwarp_f0" not in times


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_globalmv_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class whose last frame holds global
    motion and skip_mode blocks."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
