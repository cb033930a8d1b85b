"""The benchmark's own machinery: manifest, traffic draws, hooks into the
program, the window, the trace reader, the plain reference and the judge."""
