"""The benchmark's machinery: cells, configurations, traffic and metrics found
by name in data files, seeded weights and inputs, trace arithmetic, FLOP and
byte counts, and the comparison that decides ``correct``."""
