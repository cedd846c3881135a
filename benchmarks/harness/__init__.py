"""The port's benchmark harness: spec (cells by name), traffic and gen
(inputs from the seed), spans and trace (what the per-layer readers in
benchmarks/metrics/ read), check (what decides `correct`), roofline (the
frozen floors of the extraction work) and main (one run)."""
