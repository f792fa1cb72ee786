"""Depth -> pose serving: crop preprocessing, hand detection, inference,
the HTTP daemon and ``torch.export`` artifacts."""
