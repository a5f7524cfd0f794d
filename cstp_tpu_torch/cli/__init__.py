"""Command-line entry points of the port: main_byol, main_ft, main_test, main_retrieval."""
