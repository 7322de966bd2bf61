"""Training: the train step (``steps``) and the loop (``loop``)."""
