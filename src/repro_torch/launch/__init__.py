"""Launchers: serving (``serve``) and training (``train``) on one device,
and the LM steps with their input specs (``steps``); the mesh waits."""
