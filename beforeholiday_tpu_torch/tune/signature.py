"""Stable tuning keys — counterpart of ``beforeholiday_tpu/tune/signature.py``:
(model abstract signature, mesh, ChipSpec) -> digest.

A tuned configuration is only transferable between runs of the SAME program
on the SAME machine shape, so the autotuner keys its manifest on what
determines the program: the model's abstract signature (tree structure plus
leaf shapes and dtypes), the mesh geometry (axis names and sizes), and the
chip's roofline spec from :mod:`beforeholiday_tpu_torch.monitor.roofline`
(the H100's on the card). Two processes that agree on those three agree on
the digest, and a re-run is a manifest cache hit with zero trials.

The port builds its own canonical tree string — dicts by sorted key,
tuples, lists, :class:`~beforeholiday_tpu_torch.ops.arena.PackedParams`
(its arenas and the tree they pack), and ``dtype[shape]`` leaves — where
the JAX package prints a JAX treedef. For a callable it takes the abstract
outputs by running it on fake tensors (``FakeTensorMode``: shapes and
dtypes only, nothing computed; the port's kernel ops carry fake
implementations). So the port's digests are its own: a key is stable within
the port, and an entry the JAX package wrote does not hit here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Optional, Sequence, Tuple

__all__ = ["TuningKey", "tuning_key"]


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """One (model, mesh, chip) point in tuning space.

    ``model`` is the canonical abstract-signature string; ``mesh`` is
    ``((axis_name, size), ...)``; ``chip`` is ``(name, peak_tflops,
    hbm_gbs, fp8_peak_tflops)``. ``digest`` is the manifest key."""

    model: str
    mesh: Tuple[Tuple[str, int], ...]
    chip: Tuple[Any, ...]

    @property
    def digest(self) -> str:
        payload = json.dumps(
            {"model": self.model, "mesh": list(map(list, self.mesh)),
             "chip": list(self.chip)},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def describe(self) -> dict:
        """Human-readable manifest payload (the digest alone would make the
        manifest opaque to review)."""
        return {
            "model": self.model,
            "mesh": [[name, size] for name, size in self.mesh],
            "chip": list(self.chip),
            "digest": self.digest,
        }


def _leaf_sig(leaf: Any) -> str:
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).replace("torch.", "")
    elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        dtype = np.dtype(leaf.dtype).name
    else:
        return f"{type(leaf).__name__}:{leaf!r}"
    return f"{dtype}[{','.join(str(int(d)) for d in leaf.shape)}]"


def _tree_sig(tree: Any) -> str:
    """Canonical string of a tree: structure and leaf signatures."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams

    if isinstance(tree, PackedParams):
        arenas = ";".join(_leaf_sig(a) for a in tree.arenas)
        return f"PackedParams<{arenas}>({_tree_sig(tree.unpack())})"
    if isinstance(tree, Mapping):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
        return "{" + ",".join(f"{k!s}:{_tree_sig(v)}" for k, v in items) + "}"
    if isinstance(tree, tuple):
        return "(" + "".join(_tree_sig(v) + "," for v in tree) + ")"
    if isinstance(tree, list):
        return "[" + ",".join(_tree_sig(v) for v in tree) + "]"
    if tree is None:
        return "None"
    return _leaf_sig(tree)


def _abstract_signature(
    model: Any,
    example_args: Optional[Sequence[Any]],
    example_kwargs: Optional[Mapping[str, Any]],
) -> str:
    """A callable with ``example_args`` runs on fake tensors: inputs AND
    abstract outputs land in the signature (two models with identical
    params but different heads tune separately). A tree (the params)
    contributes its structure and leaf shapes and dtypes."""
    if callable(model) and example_args is not None:
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode

        from beforeholiday_tpu_torch.ops.arena import tree_map

        kwargs = dict(example_kwargs or {})
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            def fake(x):
                return mode.from_tensor(x) if isinstance(x, torch.Tensor) else x

            out = model(*tree_map(fake, tuple(example_args)),
                        **tree_map(fake, kwargs))
        return "|".join(["in:" + _tree_sig((tuple(example_args), kwargs)),
                         "out:" + _tree_sig(out)])
    if callable(model):
        raise TypeError(
            "a callable model needs example_args (shapes drive the "
            "signature); pass the params tree instead to key on parameters "
            "alone")
    return _tree_sig(model)


def _canon_mesh(mesh: Any) -> Tuple[Tuple[str, int], ...]:
    if mesh is None:
        import torch.distributed as dist

        return (("device", dist.get_world_size() if dist.is_initialized() else 1),)
    if hasattr(mesh, "axis_names") and hasattr(mesh, "ranks"):
        # parallel_state.Mesh
        return tuple((str(name), int(size))
                     for name, size in zip(mesh.axis_names, mesh.ranks.shape))
    if isinstance(mesh, Mapping):
        return tuple((str(k), int(v)) for k, v in mesh.items())
    # sequence of (axis_name, size) pairs
    return tuple((str(k), int(v)) for k, v in mesh)


def _canon_chip(chip: Any) -> Tuple[Any, ...]:
    from beforeholiday_tpu_torch.monitor import roofline as _roofline

    spec = _roofline._resolve_chip(chip)
    return (spec.name, float(spec.peak_tflops), float(spec.hbm_gbs),
            float(spec.fp8_peak))


def tuning_key(
    model: Any,
    example_args: Optional[Sequence[Any]] = None,
    *,
    example_kwargs: Optional[Mapping[str, Any]] = None,
    mesh: Any = None,
    chip: Any = None,
) -> TuningKey:
    """Build the stable tuning key for ``(model, mesh, chip)``.

    ``model`` is either a tree (typically the params — keyed on structure
    and leaf shapes and dtypes) or a callable plus ``example_args``, whose
    fake-tensor run contributes the abstract inputs AND outputs. ``mesh``
    accepts a ``parallel_state.Mesh``, a ``{axis: size}`` mapping, a
    sequence of ``(axis, size)`` pairs, or None (one flat axis over the
    process group, 1 without one). ``chip`` accepts a
    :class:`~beforeholiday_tpu_torch.monitor.roofline.ChipSpec`, a
    registered spec name, or None (the card's own spec, the CPU proxy
    without a card)."""
    return TuningKey(
        model=_abstract_signature(model, example_args, example_kwargs),
        mesh=_canon_mesh(mesh),
        chip=_canon_chip(chip),
    )
