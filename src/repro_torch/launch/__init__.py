"""Entry points of the model zoo (counterpart of ``repro.launch``)."""
