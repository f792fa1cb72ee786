"""The share of batches that the consumer found the prefetch queue empty
for and waited on (``DataLoader.stalls`` over ``DataLoader.batches``),
over the run."""

from harness import spans


def read(out):
    counts = spans.loader_counts(out)
    if counts is None:
        return None
    batches, stalls, _ = counts
    return 100.0 * stalls / batches
