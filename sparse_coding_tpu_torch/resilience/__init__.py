"""Durable-write helpers the port's store and artifacts need."""
