"""On-device image augmentation: AutoAugment, colour jitter, flip, random erasing."""
