"""The harness: finds a cell's configuration, traffic kind and metric
readers by name, makes the input, runs the window and prints the
result line."""
