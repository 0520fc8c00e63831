"""The comparisons that decide ``correct``: the plain reference, run on
the inputs the program was given, against what the timed path produced."""
