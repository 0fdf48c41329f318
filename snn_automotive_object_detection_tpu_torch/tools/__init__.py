"""Tools beside the port's CLIs: the synthetic shape set drawn on the
device (:mod:`.synth_shapes`) and the trainer of bench weights on it
(:mod:`.make_bench_weights`)."""
