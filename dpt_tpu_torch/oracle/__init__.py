"""The scalar oracle renderer: the independent reference the tests and
`chip_smoke.py` hold the vectorised renderer to."""
