"""B x S x the training steps the window completed, over its length (the
last step's end included)."""


def read(rec):
    mix = rec.cell.mix
    return rec.steps * mix["batch"] * mix["seq"] / rec.elapsed if rec.steps else None
