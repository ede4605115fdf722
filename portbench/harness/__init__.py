"""The benchmark's harness: the command line, the cell drivers, the trace
reduction, the roofline yardstick and the correctness comparison."""
