"""Plain references that judge the program's output; they import no part of
the program."""
