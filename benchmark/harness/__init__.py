"""The benchmark's harness: the manifest and its files (``manifest``),
seeded weights and scenes (``weights``, ``scenes``), the yardstick of
peaks, bytes and percentiles (``yardstick``), the profiler trace and its
reading (``trace``), and the run's context and result line (``run``)."""
