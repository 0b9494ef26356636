"""Elastic scaling: lay a training state out over another mesh, the JAX
package's ``runtime/elastic.py``.

When devices are lost or gained, the job builds its new mesh, derives the
state's shardings on it (``train.step.state_shardings``: the same logical
rules against the new axis sizes) and restores the step-atomic checkpoint
against them (``checkpointer.restore(shardings=)``), or moves a live state
(``reshard_in_memory``). Nothing about the model or the optimizer changes:
shardings are derived, not stored.
"""
from __future__ import annotations

from typing import Any

from ..checkpoint import checkpointer
from ..models.spec import place_tree
from ..train.step import abstract_train_state, state_shardings


def reshard_restore(model, ckpt_dir: str, new_mesh, *,
                    compress: bool = False, step: int | None = None) -> Any:
    """(state, step): the latest (or given) step of ``ckpt_dir`` laid out
    over ``new_mesh``."""
    if step is None:
        step = checkpointer.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    target = abstract_train_state(model, compress=compress)
    shardings = state_shardings(model, new_mesh, compress=compress)
    return checkpointer.restore(ckpt_dir, step, target, shardings), step


def reshard_in_memory(state: Any, model, new_mesh, *,
                      compress: bool = False) -> Any:
    """A live state laid out over ``new_mesh`` (no disk round trip), for
    planned topology changes: every leaf gathered and put again."""
    return place_tree(state, state_shardings(model, new_mesh,
                                             compress=compress))
