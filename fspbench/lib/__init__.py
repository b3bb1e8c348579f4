"""The benchmark's own code: configuration loading, the traffic
generator, the plain reference, the frozen work counts and the trace
reader.  Only :mod:`.port` imports the program; the request kinds
(``requests/<kind>.py``) and :mod:`.runner` reach it through it."""
