"""Soft actor-critic learner and trainer of the port."""
