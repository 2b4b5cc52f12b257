"""The frozen yardstick shared by every cell: cfg reading, FLOPs and bytes,
peaks, kernel kinds, traces, inputs from the seed and the comparisons."""
