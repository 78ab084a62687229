from .optic import Optic, Rule, Matching, MatchLocation, Action, HostRankings
