"""Steps and trainers of the port."""
