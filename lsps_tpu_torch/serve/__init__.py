"""Depth -> pose serving: crop preprocessing, hand detection, inference."""
