"""The plain reference: scene and inputs from the seed, a plain renderer
and the plain BA steps. Imports nothing of the program."""
