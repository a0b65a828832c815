"""The configurations' plain models: each module makes a configuration's
weights from a seed and computes its plain reference, importing nothing of
the program.  A configuration file names its module under ``"model"``."""
