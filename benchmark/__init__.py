"""The benchmark of convolutionalencdec: cells, traffic, references and the
reduction of traces to metrics.  `python benchmark/run.py --help`."""
