"""The benchmark's yardstick: trace reduction, FLOP and byte counts, the
card's peaks, seeded inputs and weights, the dropout counter hash and the
comparison that decides ``correct``. Imports nothing of the port, so a
change to the port cannot move what its numbers are divided by."""
