"""The ImageNet ResNet trainer — counterpart of ``examples/imagenet``."""
