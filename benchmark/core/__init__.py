"""The benchmark harness: inputs from the seed, the system under test, the
traffic generator, the traced stretch, the work and bound arithmetic and
the check against the reference."""
