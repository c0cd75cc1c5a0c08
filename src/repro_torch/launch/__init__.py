"""Entry points of the LM zoo (port of ``repro.launch``): the serve
driver, and the training driver's config resolution."""
