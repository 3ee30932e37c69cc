"""Training substrate: the functional optimizer of the continuous
trainers."""
