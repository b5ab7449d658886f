"""Per-layer metrics, one module each, found by the metric's name.

A module gives ``UNIT``, ``LAYER``, ``SOURCE``, ``MOVES`` and
``read(r)``, which returns the metric's value from a run's readings
(``harness.Readings``: the traced window's ``trace``; its tracking and
mapping calls as the comparison's wrappers saw them (``calls``: kind, and
the call's iterations and rays per iteration), from which a metric
counts its own work with the configuration (``conf``); NICE's decoder
work counted at the decoder stage (``counts``); the untraced window's
program spans (``window``); the peaks), or None where it finds nothing
to read.
"""
