"""Model families — counterpart of ``beforeholiday_tpu/models`` (ResNet)."""

from beforeholiday_tpu_torch.models import resnet  # noqa: F401

__all__ = ["resnet"]
