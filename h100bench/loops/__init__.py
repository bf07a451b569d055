"""The general loops that drive the program, one for each kind of traffic."""
