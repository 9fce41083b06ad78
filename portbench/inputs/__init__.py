"""The benchmark's input makers, frozen numpy copies of the port's: the
stress interior (stress.py) and its binary glTF writer (glb.py), the
Cornell box of principled spheres (cornell.py) and the test sky
(envmap.py). Both the program and the reference get what these make."""
