"""The benchmark's general code: loading the cells, the seeded inputs, the
clocks and spans, the profiler's arithmetic and the frozen work counts.
Nothing here belongs to one configuration, traffic mix or metric."""
