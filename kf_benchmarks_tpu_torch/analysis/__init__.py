"""Analysis helpers of the port: the program-shape fingerprints
(baseline.py) that the compile ledger and the run store key on."""
