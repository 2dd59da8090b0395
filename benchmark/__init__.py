"""The port's benchmark: `python benchmark/run.py --workload <cell> ...`
(README.md)."""
