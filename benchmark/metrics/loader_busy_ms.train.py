"""The loaders' producer threads' ms inside the dataset call a batch
(``DataLoader.busy_s`` over ``DataLoader.batches``), over the run."""

from harness import spans


def read(out):
    counts = spans.loader_counts(out)
    if counts is None:
        return None
    batches, _, busy_s = counts
    return busy_s / batches * 1e3
