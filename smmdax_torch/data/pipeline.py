"""Host batches keyed by (seed, step) (port of ``macro_batch_at`` in
``smmdax/data/pipeline.py``)."""

from __future__ import annotations

import numpy as np

Array = np.ndarray


def macro_batch_at(source, step: int, per_step: int, batch: int,
                   u8: bool = False) -> Array:
    """The (per_step, batch, ...) macro-batch of ``step``: float [-1, 1]
    from ``source.batch``, or uint8 from ``source.batch_u8`` (the
    trainer's uint8-transfer path), bit-identical to the JAX package's."""
    draw = source.batch_u8 if u8 else source.batch
    flat = draw(per_step * batch, key=step)
    return flat.reshape((per_step, batch) + flat.shape[1:])
