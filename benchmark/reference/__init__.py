"""Plain references of the benchmark's configurations. They import no
part of the program under test."""
