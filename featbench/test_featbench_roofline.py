"""The roofline's work counts against hand-worked values, and a share of
100 % when the time equals the bound."""
import pytest

from featbench.reference import semantics as S
from featbench.roofline import peaks as PK
from featbench.roofline import stages as ST

COUNTS = {"pixels": [100, 64], "searched": [100, 64], "corners": [10, 4],
          "survivors": [6, 2], "kept": [5, 2]}


def test_detect_describe_counts_by_hand():
    st = ST.detect_describe(COUNTS, disc_pixels=697, ic_pixels=749,
                            kind="bad", nbits=256)
    assert st["pyramid"].bytes == 100 and st["pyramid"].f32 == 11 * 64
    assert st["detect"].f32 == 48 * 164 + 14 * (294 + 697)
    assert st["select"].f32 == 8 + 4 * 7
    assert st["orientation"].f32 == 4 * 749 * 7
    assert st["blur"].f32 == 30 * 164
    assert st["describe"].f32 == 2 * 164 + 9 * 256 * 7
    assert st["describe"].bytes == 7 * (25 + 32)


# per keypoint: a warp of 26 ops a sample, 33 a pixel of the interior,
# 1570 to fold, normalise and quantise, and the projection
HS_256 = 26 * 1024 + 33 * 900 + 1570 + 2 * 129 * 256
HS_512 = 26 * 1024 + 33 * 900 + 1570 + 2 * 129 * 512


@pytest.mark.parametrize("kind,nbits,describe", [
    ("bad", 512, 2 * 164 + 9 * 512 * 7),
    ("hash_sift", 256, 7 * HS_256),
    ("hash_sift", 512, 7 * HS_512)])
def test_describe_counts_by_descriptor(kind, nbits, describe):
    """Only the describe stage depends on the descriptor; HashSIFT is
    charged no integral image."""
    st = ST.detect_describe(COUNTS, 697, 749, kind, nbits)
    bad = ST.detect_describe(COUNTS, 697, 749, "bad", 256)
    assert st["describe"].f32 == describe
    assert st["describe"].bytes == 7 * (25 + nbits // 8)
    assert {k: v for k, v in st.items() if k != "describe"} == \
        {k: v for k, v in bad.items() if k != "describe"}


def test_unknown_descriptor_kind_raises():
    with pytest.raises(ValueError):
        ST.detect_describe(COUNTS, 697, 749, "orb", 256)


def test_match_verify_counts_by_hand():
    st = ST.match_verify(n1=10, n2=20, nbits=256, matches=8, iters=4)
    assert st["match"].b1 == 2 * 2 * 10 * 20 * 256
    assert st["match"].int32 == 2 * 10 * 20
    assert st["match"].bytes == 10 * 32
    assert st["verify"].f32 == 4 * 902 + 5 * 8 * 23


def test_semantics_sizes():
    assert S.disc_pixels(15) == 697
    assert len(S.ic_offsets()[0]) == 749


def test_bound_is_the_slowest_resource_and_caps_the_share():
    w = ST.Work(bytes=3.35e9, f32=67e12 * 2e-3)
    assert w.ms() == pytest.approx(2.0)          # float32 ops bound it
    st = ST.detect_describe(COUNTS, 697, 749, "bad", 256)
    b = ST.bound_ms(st)
    assert ST.share_pct(b, b) == pytest.approx(100.0)
    assert ST.share_pct(b, 2 * b) == pytest.approx(50.0)
    assert ST.share_pct(b, 0.0) is None
    assert PK.PEAK_B1_TC == 8 * PK.PEAK_INT8_TC


def test_counts_of_a_small_frame_by_hand():
    """A flat 64 x 96 frame at scale 2 over 3 levels: 6144, 1536 and 384
    pixels, the last too small to search; no corner, no keypoint, so
    nothing to blur or describe."""
    import torch
    from featbench.reference import features as RF
    img = torch.full((64, 96), 90, dtype=torch.uint8)
    counts = RF.detect_and_describe(img, dict(
        nfeatures=100, scale_factor=2.0, nlevels=3, first_level=0,
        fast_threshold=20, nonmax_radius=15))
    assert counts["pixels"] == [6144, 1536, 384]
    assert counts["searched"] == [6144, 1536, 0]
    assert counts["corners"] == counts["survivors"] == counts["kept"] \
        == [0, 0, 0]
    st = ST.detect_describe(counts, 697, 749, "bad", 256)
    assert st["pyramid"].bytes == 6144
    assert st["pyramid"].f32 == 11 * (1536 + 384)
    assert st["detect"].f32 == 48 * 7680
    assert st["blur"].f32 == 0 and st["describe"].f32 == 0
    assert ST.bound_ms(st) == pytest.approx(
        1e3 * (11 * 1920 + 48 * 7680) / PK.PEAK_F32)
