"""The port's models of each architecture the benchmark runs, built from a
configuration file's keys (`spec.program_models`)."""
