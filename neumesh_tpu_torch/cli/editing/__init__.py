"""The editing CLIs: texture swapping, texture filling, geometry editing
and texture painting."""
from __future__ import annotations

import json

from ...config import ConfigDict


def config_from_argv(parser, argv=None) -> ConfigDict:
    """The editing JSON of --config with the command line laid over it: a
    flag wins where it is given (not None) or the JSON lacks its key."""
    args, _ = parser.parse_known_args(argv)
    with open(args.config) as f:
        config_dict = json.load(f)
    for k, v in vars(args).items():
        if v is not None or k not in config_dict:
            config_dict[k] = v
    return ConfigDict(config_dict)
