"""Fault injection, the straggler watchdog and restarts
(``fault_tolerance``); restoring a train state onto another mesh
(``elastic``)."""
