"""The port's score front ends against the JAX package's: MusicXML and UST
scores to full-context labels (``frontend/musicxml.py``,
``frontend/ust.py``), ``frontend.load_score``, the kana G2P, the note
names and the phoneme inventories (``frontend/{ja,zh,_inventory}.py``).
Host code copied, so the labels' text is held equal, on the port's copies
of the packaged example scores (byte-equal to the JAX package's) and on
the JAX tests' inline scores (``tests/test_ust.py``,
``tests/test_musicxml.py``): Shift-JIS, the ENUNU table override, the key
signature carried into the padding silence."""

import dataclasses
from pathlib import Path

import pytest

from ensemble_svs_with_interactions_tpu import frontend as jax_frontend
from ensemble_svs_with_interactions_tpu.frontend import (
    musicxml as jax_musicxml,
    ust as jax_ust,
)
from ensemble_svs_with_interactions_tpu.utils import misc as jax_misc
from ensemble_svs_with_interactions_tpu_torch import frontend
from ensemble_svs_with_interactions_tpu_torch.frontend import musicxml, ust
from ensemble_svs_with_interactions_tpu_torch.utils import misc
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_ust import UST

# tests/test_musicxml.py::test_padding_silence_carries_key_signature
A_MAJOR = """<?xml version="1.0" encoding="UTF-8"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"><part-name>v</part-name></score-part></part-list>
  <part id="P1">
    <measure number="1">
      <attributes>
        <divisions>4</divisions>
        <key><fifths>3</fifths></key>
        <time><beats>4</beats><beat-type>4</beat-type></time>
      </attributes>
      <direction><sound tempo="120"/></direction>
      <note><pitch><step>A</step><octave>4</octave></pitch>
            <duration>8</duration><lyric><text>あ</text></lyric></note>
      <note><pitch><step>E</step><octave>4</octave></pitch>
            <duration>8</duration><lyric><text>か</text></lyric></note>
    </measure>
  </part>
</score-partwise>
"""

# ties, a rest, a chord, <backup>/<forward>, a tempo change inside a
# measure, an altered pitch and a melisma (a note without a lyric)
TIED = """<?xml version="1.0" encoding="UTF-8"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"><part-name>v</part-name></score-part></part-list>
  <part id="P1">
    <measure number="1">
      <attributes>
        <divisions>2</divisions>
        <key><fifths>-2</fifths></key>
        <time><beats>3</beats><beat-type>4</beat-type></time>
      </attributes>
      <sound tempo="90"/>
      <forward><duration>1</duration></forward>
      <note><pitch><step>B</step><alter>-1</alter><octave>4</octave></pitch>
            <duration>2</duration><tie type="start"/>
            <lyric><text>きょ</text></lyric></note>
      <note><pitch><step>B</step><alter>-1</alter><octave>4</octave></pitch>
            <duration>1</duration><tie type="stop"/></note>
      <note><rest/><duration>2</duration></note>
    </measure>
    <measure number="2">
      <direction><sound tempo="140"/></direction>
      <note><pitch><step>C</step><octave>5</octave></pitch>
            <duration>2</duration><lyric><text>ハー</text></lyric></note>
      <note><chord/><pitch><step>E</step><octave>5</octave></pitch>
            <duration>2</duration></note>
      <note><pitch><step>D</step><octave>5</octave></pitch>
            <duration>2</duration></note>
      <backup><duration>1</duration></backup>
      <note><pitch><step>F</step><alter>1</alter><octave>5</octave></pitch>
            <duration>3</duration><lyric><text>っと</text></lyric></note>
    </measure>
  </part>
</score-partwise>
"""


@pytest.mark.parametrize("name", ["example_song.musicxml",
                                  "example_song.ust"])
def test_example_data_copies_are_byte_equal(name):
    """The port keeps its own copy of the packaged example scores, byte-
    equal to the JAX package's."""
    port = {"example_song.musicxml": misc.example_xml_file,
            "example_song.ust": misc.example_ust_file}[name]()
    ref = {"example_song.musicxml": jax_misc.example_xml_file,
           "example_song.ust": jax_misc.example_ust_file}[name]()
    assert Path(port).name == name
    assert Path(port).parent.parent.name == (
        "ensemble_svs_with_interactions_tpu_torch")
    assert Path(port).read_bytes() == Path(ref).read_bytes()


LYRICS = ["は", "しゃ", "ん", "っ", "きょ", "ハル", "ka", "a i u", "ずぃ",
          "ちぇ", "ゔぁ", "ー", "きゃー", "xyz", "", "  ", "ふゅ", "てぃ"]


@pytest.mark.parametrize("lyric", LYRICS)
def test_g2p_ja_matches_jax(lyric):
    for prev in (None, "o"):
        assert musicxml.g2p_ja(lyric, prev) == jax_musicxml.g2p_ja(lyric,
                                                                   prev)


def test_midi_to_name_matches_jax():
    for midi in range(0, 128):
        assert musicxml.midi_to_name(midi) == jax_musicxml.midi_to_name(midi)


@pytest.mark.parametrize("lang", ["ja", "zh"])
def test_phoneme_inventories_match_jax(lang):
    mod, ref = getattr(frontend, lang), getattr(jax_frontend, lang)
    assert mod.phonemes == ref.phonemes and mod.symbols == ref.symbols
    assert mod.num_vocab() == ref.num_vocab()
    seq = mod.text_to_sequence(mod.phonemes[::-1])
    assert seq == ref.text_to_sequence(ref.phonemes[::-1])
    assert mod.sequence_to_text(seq) == ref.sequence_to_text(seq)


def _notes(notes):
    return [dataclasses.asdict(n) for n in notes]


SCORES = {"example": None, "a_major": A_MAJOR, "tied": TIED}


@pytest.mark.parametrize("score", sorted(SCORES))
def test_musicxml_labels_match_jax(tmp_path, score):
    """``parse_musicxml``'s notes field by field and the labels' text of
    ``musicxml_to_labels`` equal JAX's; the key signature reaches every
    label of the A-major score, the padding silence's too."""
    path = misc.example_xml_file()
    if SCORES[score] is not None:
        path = tmp_path / f"{score}.xml"
        path.write_text(SCORES[score])
    assert _notes(musicxml.parse_musicxml(path)) == _notes(
        jax_musicxml.parse_musicxml(path))
    got = musicxml.musicxml_to_labels(path)
    ref = jax_musicxml.musicxml_to_labels(path)
    assert str(got) == str(ref)
    assert len(got) > 3
    if score == "a_major":
        assert all("^9=" in c for c in got.contexts)


UST_CASES = ("example", "inline_utf8", "inline_sjis", "inline_table",
             "inline_text")


@pytest.mark.parametrize("case", UST_CASES)
def test_ust_labels_match_jax(tmp_path, case):
    """``parse_ust``'s notes and ``ust_to_labels``' text equal JAX's: the
    example score, the JAX test's inline score as UTF-8, as Shift-JIS, with
    a ``kana2phonemes.table`` and passed as text."""
    table = None
    if case == "example":
        src = misc.example_ust_file()
    elif case == "inline_text":
        src = UST
    else:
        src = tmp_path / "song.ust"
        src.write_bytes(UST.encode("cp932" if case == "inline_sjis"
                                   else "utf-8"))
    if case == "inline_table":
        table = tmp_path / "kana2phonemes.table"
        table.write_text("か g a\n# comment\nた d a\n", encoding="utf-8")
        assert ust.load_table(table) == jax_ust.load_table(table)
    assert _notes(ust.parse_ust(src, table=table)) == _notes(
        jax_ust.parse_ust(src, table=table))
    got = ust.ust_to_labels(src, table=table)
    assert str(got) == str(jax_ust.ust_to_labels(src, table=table))
    if case == "inline_table":
        assert any("-g+" in c for c in got.contexts)


def test_clean_lyric_matches_jax():
    for lyric in ("か", "a か", "- か", "かC4", " R ", "", "ー", "a"):
        assert ust.clean_lyric(lyric) == jax_ust.clean_lyric(lyric)


LOAD_SCORE = {
    "musicxml_bytes": ("song.MusicXML", lambda: Path(
        misc.example_xml_file()).read_bytes()),
    "xml_text": ("song.xml", lambda: A_MAJOR),
    "ust_sjis_bytes": ("song.ust", lambda: UST.encode("cp932")),
    "ust_text": ("song.UST", lambda: UST),
    "labels": ("song.lab", lambda: str(jax_musicxml.musicxml_to_labels(
        misc.example_xml_file()))),
    "labels_bytes": ("song", lambda: str(jax_musicxml.musicxml_to_labels(
        misc.example_xml_file())).encode()),
}


@pytest.mark.parametrize("case", sorted(LOAD_SCORE))
def test_load_score_matches_jax(case):
    """``load_score``'s three branches (MusicXML, UST, HTS labels), from
    bytes and from text, give JAX's labels."""
    name, content = LOAD_SCORE[case]
    got = frontend.load_score(name, content())
    ref = jax_frontend.load_score(name, content())
    assert type(got).__module__.startswith(
        "ensemble_svs_with_interactions_tpu_torch.")
    assert str(got) == str(ref)
    assert list(got.start_times) == list(ref.start_times)
