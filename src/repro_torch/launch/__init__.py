"""Launchers: serving (``serve``) and training (``train``), the dry-run
(``dryrun``), the LM steps with their input specs (``steps``), and the
mesh (``mesh``) with its placement rules (``partition``)."""
