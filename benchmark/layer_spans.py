"""Device time of one model's layer span inside generation, per traced unit.

`program_spans.py` puts each device record down to the innermost of the
program's spans whose names begin with `program_spans.PROGRAM`; a model's
layer spans (StyleGAN3's `sg3.input`, `sg3.modconv`, `sg3.filtered_lrelu`,
`rick_tpu_torch/nn/stylegan3.py`) are not among them, so that
`gen_device_ms.eval` keeps the whole of generation.  Here the same pairing
of records with their launches puts each record down to the innermost of
the program's spans and the spans named `name`.  A program without such
spans gives nothing.
"""

from __future__ import annotations

from typing import Optional

from benchmark import program_spans


def ms_per_unit(record, name: str, unit: str) -> Optional[float]:
    """Device ms launched inside the spans named `name` (innermost among
    them and the program's spans), per traced `unit`."""
    cap = record.capture
    done = record.window.traced_work.get(unit)
    if cap is None or not cap.device or not done:
        return None
    spans = [x for x in cap.spans if x[0].startswith(program_spans.PROGRAM + (name,))]
    if not any(x[0] == name for x in spans):
        return None
    records, paired = program_spans.pairs(cap)
    if paired is None:
        return None
    names = [None] * (len(records) - len(paired)) + program_spans._innermost(spans, paired)
    return sum(e - s for span, (_, s, e) in zip(names, records) if span == name) / done / 1e6
