"""Score front ends: the linguistic features (``merlin``, a copy of the JAX
package's ``frontend/merlin.py``), the phoneme inventories (``ja``,
``zh``), MusicXML (``musicxml``) and UST (``ust``) scores to full-context
labels, and :func:`load_score`, a copy of the JAX package's
``frontend.load_score``."""

from ensemble_svs_with_interactions_tpu_torch.frontend import (  # noqa: F401
    ja,
    merlin,
    zh,
)


def load_score(filename, content):
    """Dispatch a score upload to full-context labels by filename suffix.

    ``content`` may be bytes or text; .xml/.musicxml goes through the
    MusicXML frontend, .ust through the UST frontend, anything else is
    parsed as HTS full-context labels.  Shared by the NEUTRINO server and
    the NEUTRINO engine's callers."""
    name = str(filename).lower()
    if isinstance(content, bytes):
        if name.endswith(".ust"):  # USTs are conventionally Shift-JIS
            for enc in ("utf-8-sig", "cp932", "utf-8"):
                try:
                    content = content.decode(enc)
                    break
                except UnicodeDecodeError:
                    continue
            else:
                content = content.decode("utf-8", errors="replace")
        else:
            content = content.decode("utf-8")
    if name.endswith((".xml", ".musicxml")):
        import io as _io

        from ensemble_svs_with_interactions_tpu_torch.frontend.musicxml import (
            parse_musicxml,
            score_to_labels,
        )

        return score_to_labels(parse_musicxml(_io.StringIO(content)))
    if name.endswith(".ust"):
        from ensemble_svs_with_interactions_tpu_torch.frontend.ust import (
            ust_to_labels,
        )

        return ust_to_labels(content)
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    return hts.loads(content)
