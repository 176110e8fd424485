"""The plain reference: the exact engine and PAF I/O frozen from the port,
and the device layer (dag.py); it imports nothing of the program."""
