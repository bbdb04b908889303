"""The plain reference that decides ``correct``: numpy only, importing
nothing of the program."""
