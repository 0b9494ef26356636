"""Fault injection, the straggler watchdog and restarts
(``fault_tolerance``)."""
