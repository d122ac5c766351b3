"""Drivers: each builds a cell's program from the configuration file, warms it up,
drives its measured window and hands its outputs to the comparison."""
