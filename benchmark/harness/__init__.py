"""The benchmark's yardstick: loading cells, scenes, weights, the trace
reduction, FLOP and byte counts, peaks and the comparison that decides
``correct``.  Nothing here imports JAX or the JAX package; only the traffic
generators under ``benchmark/traffic`` import the program (``vlsat_tpu_torch``).
"""
