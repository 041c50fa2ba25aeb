"""Bulk traffic: batches of terminated packets, a closed loop over
distinct device-resident buffers, one `block_until_ready` per round.

The request is one call (`batch` packets).  The check compares the
answers of a sample of calls drawn from the seed, and of the last round,
bit for bit with the plain reference's whole-packet decode of the same
buffer, every packet of the batch.
"""

from __future__ import annotations

import functools

import jax

from benchmark.harness import channel, spec, work
from benchmark.harness.window import (Checks, closed_loop, keep_mask,
                                      mismatched_bits)


def program(cfg: dict):
    """The program's entry the window drives, as (call(x) -> output, form
    of the output: "bytes" packed MSb first, or "bits")."""
    import convolutionalencdec as fec
    from convolutionalencdec import kernels
    K, gens = cfg["code"]["K"], tuple(cfg["code"]["generators"])
    code = fec.CodeSpec(K=K, g=gens)
    if cfg["input"] == "hard":
        return functools.partial(kernels.viterbi_decode_batch_bytes, code), "bytes"
    if cfg["input"] == "soft_punctured":
        pattern = tuple(tuple(r) for r in cfg["puncture"])
        T = cfg["packet_bits"] + K - 1
        return (lambda q: kernels.viterbi_decode_batch_punctured_soft(
            code, q, pattern, T)), "bits"
    raise ValueError(f"unknown input form {cfg['input']!r}")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.K = cfg["code"]["K"]
        self.gens = tuple(cfg["code"]["generators"])
        self.L = cfg["packet_bits"]
        self.T = self.L + self.K - 1
        self.rows = traffic["batch"]
        self.ref = spec.reference(cfg["reference"])
        self.bufs = channel.make_buffers(cfg, self.rows, self.L, seed,
                                         traffic["buffers"])
        self.call, self.form = program(cfg)
        self.keep = keep_mask(seed, traffic["sample_share"])
        self.kept = []

    def warm(self):
        jax.block_until_ready([self.call(x) for x in self.bufs])

    def window(self, seconds: float, annotate: bool):
        win, self.kept = closed_loop(self.call, self.bufs,
                                     self.rows * self.L, seconds, self.keep,
                                     annotate)
        return win

    def work(self) -> dict:
        in_bytes = self.bufs[0].shape[1] * self.bufs[0].dtype.itemsize
        return work.decode_work(self.T, self.rows, self.K, in_bytes, self.L)

    @functools.cached_property
    def control_bufs(self):
        """The same channel outputs quantized at the control's `qmax`."""
        cfg = {**self.cfg, "channel": {**self.cfg["channel"],
                                       "qmax": self.cfg["control"]["qmax"]}}
        return channel.make_buffers(cfg, self.rows, self.L, self.seed,
                                    len(self.bufs))

    def reference_output(self, j: int, control: bool = False):
        """The reference's answer for buffer j in the program's output
        form; with `control`, the configuration's control instead."""
        ctl = self.cfg["control"] if control else {}
        x = self.control_bufs[j] if "qmax" in ctl else self.bufs[j]
        if self.cfg["input"] == "soft_punctured":
            x = self.ref.depuncture(x, self.cfg["puncture"], self.T)
        if "decision_depth" in ctl:
            bits = self.ref.stream_decode(x, self.K, self.gens, ctl["chunk"],
                                          ctl["decision_depth"])
        else:
            bits = self.ref.block_decode(x, self.K, self.gens, self.L)
        return self.ref.pack_bits(bits) if self.form == "bytes" else bits

    def check(self) -> Checks:
        self.call = None
        refs, per = {}, []
        for j, out in self.kept:
            if j not in refs:
                refs[j] = self.reference_output(j)
            per.append(mismatched_bits(out, refs[j]))
        return Checks({"mismatched_bits": (sum(per), 0)}, len(per),
                      sum(p > 0 for p in per))

    def use_control(self):
        """The reference at the configuration's control setting in the
        program's place: each call answers with the control's decode of
        the buffer it is given."""
        index = {id(x): j for j, x in enumerate(self.bufs)}
        self.call = lambda x: self.reference_output(index[id(x)], control=True)
