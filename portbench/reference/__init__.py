"""The plain reference and the comparison that decides `correct`.
Imports numpy and torch only: nothing of the program."""
