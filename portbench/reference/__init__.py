"""The benchmark's yardstick: plain references, frozen input generators
and the comparisons that decide ``correct``.  Plain numpy and PyTorch;
imports nothing of the program under test."""
