"""Step builders and the serving loop of the port's model path."""
