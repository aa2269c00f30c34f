"""Per-shard random streams (counterpart of ``bluefog_tpu/parallel/rng.py``).

Under ``shard_map`` every device of the JAX package sees the same base key,
and ``fold_axis_rng`` folds its mesh position in so that shards of one
parameter draw independent values.  Here the shards of a parameter are the
rows of one stacked tensor, and each row draws from an explicit
``torch.Generator`` seeded from ``(seed, index along the axis)``.  JAX's
``fold_in`` stream cannot be matched, so the two packages agree through
converted weights (:mod:`bluefog_tpu_torch.convert`), never through their
initialisations.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["fold_axis_rng", "sharded_init"]

# an initializer: (generator, shape) -> f32 CPU tensor of that shape
Init = Callable[[torch.Generator, Sequence[int]], torch.Tensor]


def fold_axis_rng(seed: int, *indices: int) -> torch.Generator:
    """A generator for ``seed`` with each mesh index folded in, so that the
    shards along an axis draw independent values (the same indices give the
    same stream)."""
    words = np.random.SeedSequence([int(seed), *map(int, indices)])
    return torch.Generator().manual_seed(
        int(words.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def sharded_init(base_init: Init, lead: Sequence[int],
                 fold_dim: Optional[int]) -> Callable[[int, Sequence[int]],
                                                      torch.Tensor]:
    """Wrap ``base_init`` into ``init(seed, local_shape)`` -> a stacked
    ``(*lead, *local_shape)`` tensor: the rows along the leading dimension
    ``fold_dim`` (a sharded axis) each from :func:`fold_axis_rng` ``(seed,
    index)``, the other leading dimensions copies (replicas); with
    ``fold_dim`` None every row is the one draw of ``seed``."""
    lead = tuple(lead)

    def init(seed: int, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        if fold_dim is None:
            one = base_init(fold_axis_rng(seed), shape)
            return one.expand(*lead, *shape).clone()
        rows = torch.stack([base_init(fold_axis_rng(seed, i), shape)
                            for i in range(lead[fold_dim])])
        view = [1] * len(lead)
        view[fold_dim] = lead[fold_dim]
        rows = rows.reshape(*view, *shape)
        return rows.expand(*lead, *shape).clone()

    return init
