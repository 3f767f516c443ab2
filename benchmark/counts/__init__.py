"""The yardstick's arithmetic: operations and bytes from shapes and from a
launch's own inputs, and the card's published peaks.  Nothing here imports
the program; a count depends on what a call is given, never on how the
program computes it."""
