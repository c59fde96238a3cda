"""The benchmark's yardstick: traffic generators, weights from the seed, the
work each operation needs at a cell's shapes, the card's data-sheet peaks and
the reduction of a profiler trace."""
