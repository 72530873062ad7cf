"""The AgileNN system: split, combine, the deployment forward."""
