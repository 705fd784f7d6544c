"""The port's AV1 decoder on the segmentation features other than ALT_Q
and on ``delta_lf_multi`` (spec 5.9.14, 5.9.18, 5.11.9-13, 7.14.4), on the
CPU and with no tolerance.

libaom writes none of these into a key frame, so the fixtures
(``tests/torch_fixtures/avif_lf_seg``, ``make_avif_lf_seg.py``) are
written symbol by symbol by ``keyframe_writer.py`` beside them:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  gives the reference's ``load_avif`` and ``decode_avif_to_rgb8`` pixels,
  live and against its manifest, and regenerates byte for byte from its
  seed;
- zeroing an ALT_LF feature's values, or every DeltaLF delta of a
  ``delta_lf_multi`` stream, changes dav1d's pixels in the planes it
  filters; the same tile under a header whose features leave SegIdPreSkip
  0 fails in dav1d or decodes to other pixels, so the SKIP, REF_FRAME and
  GLOBALMV streams decode only with the id read before ``skip``;
- luma levels of 0 leave every plane unfiltered, whatever the segments'
  ALT_LF (dav1d gives the pixels of the stream without them);
- each new counter, and ``seg_preskip``, occurs;
- the CLI on one of these files gives the reference CLI's q and passes
  and the bytes of the port's CLI on its pixels as PAM.
"""

from __future__ import annotations

import copy
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_lf_seg"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(FIXTURES))

import make_avif_lf_seg as MK  # noqa: E402
from keyframe_writer import avif_still, frame_obus  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.image import load_avif  # noqa: E402
from test_torch_avif_container import check_fixture  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NEW_COUNTERS = ("seg_alt_lf", "seg_skip", "delta_lf_multi", "seg_preskip")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _frame(name: str):
    return MK.frame(name, MANIFEST[name]["written"]["seed"])


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_manifest(name):
    check_fixture(FIXTURES, name, MANIFEST[name])


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_regenerates_from_its_seed(name):
    fr = _frame(name)
    assert avif_still(frame_obus(fr), fr) == (FIXTURES / name).read_bytes()


PROOFS = sorted(n for n, e in MANIFEST.items()
                if e["written"]["proves"] is not None)


@pytest.mark.parametrize("name", PROOFS)
def test_feature_moves_dav1d_pixels(name):
    """For an ALT_LF feature and for ``delta_lf_multi``: dav1d decodes the
    stream with the feature's values zeroed to other pixels in the planes
    the feature filters. For SKIP, REF_FRAME and GLOBALMV: the tile needs
    the id before ``skip``, and the port read it there."""
    assert MK.proven(name, _frame(name))
    tools = MANIFEST[name]["tools"]
    proves = MANIFEST[name]["written"]["proves"]
    if proves == MK.PRESKIP:
        assert tools["seg_preskip"] > 0
        assert (tools["seg_skip"] > 0) == name.startswith("skip")
    elif proves == MK.MULTI:
        assert tools["delta_lf_multi"] > 0
    else:
        assert tools["seg_alt_lf"] > 0


def test_seven_features_each_alone():
    """One stream for each feature but ALT_Q, holding it alone."""
    alone = {}
    for name, e in MANIFEST.items():
        fr = MK.SPECS[name][0]
        if fr.features is None:
            continue
        on = {j for seg in fr.features for j, v in enumerate(seg)
              if v is not None and (j or v)}
        if len(on) == 1:
            alone[on.pop()] = name
    assert sorted(alone) == list(range(1, 8))


def test_segment7_alt_lf_v_moves_dav1d_pixels():
    """ALT_LF_V on segment 7, the top bit of the header's 32-bit ALT_LF
    mask: with LastActiveSegId 7, zeroing that one value changes dav1d's
    V plane, and the port decodes the stream (its manifest holds it to
    dav1d and the reference)."""
    name = "alt_lf_v_seg7_420.avif"
    fr = _frame(name)
    assert fr.last_active == 7 and fr.features[7][4] > 0
    z = copy.deepcopy(fr)
    z.features[7][4] = 0
    assert MK.changed_planes(fr, frame_obus(z)) == [2]
    assert A.decode_avif((FIXTURES / name).read_bytes())[1].tools[
        "seg_alt_lf"] > 0


def test_zero_luma_levels_filter_nothing():
    """Luma levels 0 with positive ALT_LF: dav1d filters no plane, so the
    stream decodes as it does without its features."""
    name = "zero_luma_alt_lf_420.avif"
    fr = _frame(name)
    assert fr.lf[:2] == (0, 0) and any(v for v in fr.features[1][1:5])
    for j in (1, 2, 3, 4):
        assert MK.changed_planes(fr, frame_obus(MK.zeroed(fr, j))) == []
    assert MANIFEST[name]["tools"]["seg_alt_lf"] > 0


@pytest.mark.parametrize("counter", NEW_COUNTERS)
def test_each_new_counter_occurs(counter):
    assert sum(e["tools"][counter] for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_promised_settings():
    how = {n: e["written"] for n, e in MANIFEST.items()}
    assert {h["subsampling"] for h in how.values()} == {"4:0:0", "4:2:0",
                                                         "4:4:4"}
    assert {h["depth"] for h in how.values()} == {8, 10}
    assert {h["sb128"] for h in how.values()} == {False, True}
    assert {tuple(h["size"]) for h in how.values()} >= {(512, 512),
                                                        (3840, 2160)}
    frames = {n: MK.SPECS[n][0] for n in MANIFEST}
    multi = [f for f in frames.values() if f.delta_lf and f.delta_lf[1]]
    assert {f.delta_lf[0] for f in multi} >= {0, 2}
    assert any(f.mono for f in multi)
    assert {repr(f.lf_delta) for f in frames.values()} >= {"True", "-6",
                                                           "0", "None"}
    assert any(f.cdef for f in frames.values())
    assert any(f.last_active == 7 and f.features[7][4] is not None
               for f in frames.values())
    combined = frames["combined_420_10b_sb128.avif"]
    assert combined.last_active < 7
    assert {j for seg in combined.features for j, v in enumerate(seg)
            if v is not None} == set(range(8))


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 200_000


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_lf_seg_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the ALT_LF_Y_V stream."""
    from chip_smoke import write_pam

    args = ["-t", "80"]
    src = FIXTURES / "alt_lf_y_v_420.avif"
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
    assert A.decode_avif(src.read_bytes())[1].tools["seg_alt_lf"] > 0
    assert np.array_equal(load_avif(str(src)).data.shape, (192, 256, 3))
