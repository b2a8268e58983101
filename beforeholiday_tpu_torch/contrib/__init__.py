"""Optional modules (ref: apex/contrib/) — counterpart of
``beforeholiday_tpu/contrib``.

Ported: ``xentropy`` (:func:`softmax_cross_entropy_loss`, Apex's fused
label-smoothing cross entropy, on kernels K14/K15). The rest of the JAX
package's ``contrib/`` (``fmha``, ``multihead_attn``, ``clip_grad``,
``focal_loss``, ``bottleneck``, ``groupbn``, ...) is still to be ported; see
``ROADMAP.md``, queue A (A15).
"""

from beforeholiday_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss  # noqa: F401

__all__ = ["softmax_cross_entropy_loss"]
