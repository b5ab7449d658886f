"""The port's benchmark: ``python3 slambench/run.py --workload W --seed N
--seconds S --trace 0|1`` (see README.md)."""
